"""Audio pull-stream helpers for SDK-style continuous recognition.

Reference: cognitive/AudioStreams.scala — ``WavStream`` parses the RIFF
header and exposes fixed-size PCM frame pulls; ``CompressedStream`` passes
opaque compressed bytes through untouched. These feed
:class:`mmlspark_tpu_torch.cognitive.speech.SpeechToTextSDK`'s windowed
continuous-recognition loop (SpeechToTextSDK.scala:204-249).

The PyTorch port's copy of ``mmlspark_tpu.cognitive.audio``: host code,
no device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class WavFormat:
    channels: int
    sample_rate: int
    bits_per_sample: int

    @property
    def bytes_per_second(self) -> int:
        return self.sample_rate * self.channels * (self.bits_per_sample // 8)


class WavStream:
    """Parse a PCM WAV blob; iterate raw PCM in fixed-duration windows."""

    def __init__(self, data: bytes):
        self.format, self.pcm = self._parse(bytes(data))

    @staticmethod
    def _parse(data: bytes) -> tuple:
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE stream")
        pos = 12
        fmt: Optional[WavFormat] = None
        pcm = b""
        while pos + 8 <= len(data):
            chunk_id = data[pos : pos + 4]
            (size,) = struct.unpack_from("<I", data, pos + 4)
            body = data[pos + 8 : pos + 8 + size]
            if chunk_id == b"fmt ":
                try:
                    audio_fmt, channels, rate = struct.unpack_from("<HHI", body, 0)
                    bits = struct.unpack_from("<H", body, 14)[0]
                except struct.error as e:  # truncated fmt chunk
                    raise ValueError(f"malformed WAV fmt chunk: {e}") from e
                if audio_fmt not in (1, 0xFFFE):  # PCM / extensible
                    raise ValueError(f"unsupported WAV audio format {audio_fmt}")
                if channels < 1 or rate < 1 or bits < 8:
                    raise ValueError(
                        f"invalid WAV format: channels={channels} rate={rate} bits={bits}"
                    )
                fmt = WavFormat(channels, rate, bits)
            elif chunk_id == b"data":
                pcm = body
            pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is None:
            raise ValueError("WAV stream has no fmt chunk")
        return fmt, pcm

    @property
    def duration_seconds(self) -> float:
        return len(self.pcm) / max(self.format.bytes_per_second, 1)

    def windows(self, window_seconds: float = 15.0) -> Iterator[bytes]:
        """Yield PCM windows re-wrapped as standalone WAV blobs (the REST
        endpoint consumes whole files; sample-aligned, no torn frames)."""
        step = int(self.format.bytes_per_second * window_seconds)
        frame = self.format.channels * (self.format.bits_per_sample // 8)
        step -= step % max(frame, 1)
        step = max(step, frame)
        for lo in range(0, len(self.pcm), step):
            yield wrap_wav(self.pcm[lo : lo + step], self.format)

    def pull(self, chunk_bytes: int = 3200) -> Iterator[bytes]:
        """The pull-stream read contract (AudioStreams.scala ``read(buf)``):
        fixed-size frame-aligned PCM chunks until exhaustion. 3200 B =
        100 ms of 16 kHz/16-bit mono, the SDK's default pull size."""
        frame = self.format.channels * (self.format.bits_per_sample // 8)
        chunk_bytes -= chunk_bytes % max(frame, 1)
        chunk_bytes = max(chunk_bytes, frame)
        for lo in range(0, len(self.pcm), chunk_bytes):
            yield self.pcm[lo : lo + chunk_bytes]

    def fixed_segments(self, window_seconds: float = 15.0) -> list:
        """Fixed-length windows with exact stream offsets: the same
        (wav_blob, offset_ticks, duration_ticks) contract as
        :meth:`segments`, durations as tick DIFFERENCES so they tile."""
        fmt = self.format
        bps = fmt.bytes_per_second
        step = _win_step(fmt, window_seconds)
        out = []
        for i, w in enumerate(self.windows(window_seconds)):
            b0 = i * step
            b1 = min(b0 + step, len(self.pcm))
            out.append((w, _ticks(b0, bps), _ticks(b1, bps) - _ticks(b0, bps)))
        return out

    def segments(
        self,
        max_seconds: float = 15.0,
        min_silence_s: float = 0.3,
        silence_rel: float = 0.08,
    ) -> list:
        """Phrase-boundary segmentation: split at energy dips (silence runs
        of >= ``min_silence_s`` whose RMS is below ``silence_rel`` x the
        stream's 95th-percentile frame RMS), capped at ``max_seconds`` —
        what continuous recognition's VAD does between utterances
        (SpeechToTextSDK.scala's session emits one result per recognized
        phrase, not per arbitrary window). Returns a list of
        ``(wav_blob, offset_ticks, duration_ticks)`` with offsets in the
        service's 100-ns ticks, rebased to the START of the stream.

        Falls back to fixed windows (with exact offsets) for non-16-bit
        PCM, where frame energies aren't directly readable."""
        import numpy as np

        fmt = self.format
        bps = max(fmt.bytes_per_second, 1)

        def ticks(byte_off: int) -> int:
            return _ticks(byte_off, bps)

        frame = fmt.channels * (fmt.bits_per_sample // 8)
        if fmt.bits_per_sample != 16 or len(self.pcm) < frame:
            return self.fixed_segments(max_seconds)
        samples = np.frombuffer(
            self.pcm[: len(self.pcm) - len(self.pcm) % frame], np.int16
        ).astype(np.float32)
        if fmt.channels > 1:
            samples = samples.reshape(-1, fmt.channels).mean(axis=1)
        # 20 ms analysis frames
        hop = max(int(fmt.sample_rate * 0.02), 1)
        n_frames = len(samples) // hop
        if n_frames == 0:
            return [(wrap_wav(self.pcm, fmt), 0, ticks(len(self.pcm)))]
        rms = np.sqrt(
            (samples[: n_frames * hop].reshape(n_frames, hop) ** 2).mean(axis=1)
        )
        loud = np.percentile(rms, 95)
        silent = rms < max(loud * silence_rel, 1e-3)
        min_run = max(int(min_silence_s / 0.02), 1)
        # boundaries at the middle of each long-enough silence run
        bounds = []
        run = 0
        for i, s in enumerate(silent):
            run = run + 1 if s else 0
            if run == min_run:
                bounds.append((i - min_run // 2) * hop)
        max_samples = max(int(fmt.sample_rate * max_seconds), hop)
        segs: list = []
        start = 0
        cuts = bounds + [len(samples)]
        for cut in cuts:
            while cut - start > max_samples:  # cap long phrases
                segs.append((start, start + max_samples))
                start += max_samples
            if cut > start:
                segs.append((start, cut))
                start = cut
        out = []
        for s0, s1 in segs:
            b0, b1 = s0 * frame, s1 * frame
            chunk = self.pcm[b0:b1]
            if not chunk:
                continue
            # duration as a tick DIFFERENCE so consecutive segments tile
            # the stream exactly (floor-divided ticks(b1-b0) would drift)
            out.append((wrap_wav(chunk, fmt), ticks(b0), ticks(b1) - ticks(b0)))
        return out


def _ticks(byte_off: int, bps: int) -> int:
    """Byte offset -> 100-ns ticks, integer-exact (consecutive segments'
    offsets/durations must tile the stream with no 1-tick drift)."""
    return byte_off * 10_000_000 // max(bps, 1)


class CompressedStream:
    """Opaque compressed audio: single pull of the whole payload
    (CompressedStream in the reference defers decode to the service)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)

    def windows(self, window_seconds: float = 15.0) -> Iterator[bytes]:
        yield self.data


def _win_step(fmt: WavFormat, window_seconds: float) -> int:
    """Byte step of :meth:`WavStream.windows` (frame-aligned)."""
    step = int(fmt.bytes_per_second * window_seconds)
    frame = fmt.channels * (fmt.bits_per_sample // 8)
    step -= step % max(frame, 1)
    return max(step, frame)


def wrap_wav(pcm: bytes, fmt: WavFormat) -> bytes:
    """Minimal RIFF/WAVE envelope around raw PCM."""
    byte_rate = fmt.bytes_per_second
    block_align = fmt.channels * (fmt.bits_per_sample // 8)
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, fmt.channels, fmt.sample_rate, byte_rate, block_align,
        fmt.bits_per_sample,
    )
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm
