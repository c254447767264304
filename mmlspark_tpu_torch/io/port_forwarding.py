"""SSH port forwarding for serving behind NAT (io/http/PortForwarding.scala).

The PyTorch port's copy of ``mmlspark_tpu.io.port_forwarding`` (stdlib only).

The reference opens jsch remote-forward sessions so an executor-local
serving port is reachable from a gateway host. Here the tunnel is an
``ssh -N -R`` child process managed with context semantics; serving's
WorkerServer can attach one per host (HTTPSourceV2.scala:657-665 analogue).
No paramiko in the image — the system ssh client is the transport.
"""

from __future__ import annotations

import shlex
import subprocess
import time
from typing import Optional


def build_forward_command(
    remote_host: str,
    remote_port: int,
    local_port: int,
    user: Optional[str] = None,
    key_file: Optional[str] = None,
    bind_address: str = "",
    ssh_options: Optional[dict] = None,
) -> list:
    """Construct the ``ssh -N -R`` argv for a remote forward
    remote_host:remote_port -> localhost:local_port."""
    spec = f"{bind_address}:{remote_port}:127.0.0.1:{local_port}" if bind_address else f"{remote_port}:127.0.0.1:{local_port}"
    cmd = ["ssh", "-N", "-R", spec]
    opts = {
        # trust-on-first-use: record unseen host keys, refuse changed ones.
        # Needs OpenSSH >= 7.6; on older clients (or to opt out) pass
        # ssh_options={"StrictHostKeyChecking": "no"}.
        "StrictHostKeyChecking": "accept-new",
        "ExitOnForwardFailure": "yes",
        "ServerAliveInterval": "30",
    }
    opts.update(ssh_options or {})
    for k, v in sorted(opts.items()):
        cmd += ["-o", f"{k}={v}"]
    if key_file:
        cmd += ["-i", key_file]
    target = f"{user}@{remote_host}" if user else remote_host
    cmd.append(target)
    return cmd


class PortForwarding:
    """Managed reverse-forward tunnel; ``with PortForwarding(...) :`` or
    explicit start/stop."""

    def __init__(
        self,
        remote_host: str,
        remote_port: int,
        local_port: int,
        user: Optional[str] = None,
        key_file: Optional[str] = None,
        **ssh_options: str,
    ):
        self.command = build_forward_command(
            remote_host, remote_port, local_port, user, key_file,
            ssh_options=ssh_options or None,
        )
        self._proc: Optional[subprocess.Popen] = None

    @property
    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def start(self, settle_seconds: float = 0.5) -> "PortForwarding":
        if self.running:
            return self
        self._proc = subprocess.Popen(
            self.command, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE
        )
        time.sleep(settle_seconds)
        if self._proc.poll() is not None:  # died immediately: surface stderr
            err = (self._proc.stderr.read() if self._proc.stderr else b"").decode(
                "utf-8", "replace"
            )
            self._proc = None
            raise RuntimeError(
                f"ssh forward failed ({shlex.join(self.command)}): {err.strip()}"
            )
        # long-lived tunnel: drain stderr in the background so a chatty ssh
        # (keepalive warnings, -v) can never fill the pipe and block forwarding
        stderr = self._proc.stderr

        def _drain() -> None:
            try:
                while stderr.read(65536):
                    pass
            except (OSError, ValueError):
                pass

        import threading

        threading.Thread(target=_drain, name="ssh-stderr-drain", daemon=True).start()
        return self

    def stop(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        self._proc = None

    def __enter__(self) -> "PortForwarding":
        return self.start()

    def __exit__(self, *exc: object) -> None:
        self.stop()
