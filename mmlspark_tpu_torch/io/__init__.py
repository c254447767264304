"""IO layer of the port: so far only the SSH reverse forward a serving
worker can open for its port (:mod:`port_forwarding`). The rest of the JAX
package's ``io/`` (HTTP schema and clients, parsers, binary and CSV
readers) is still to be ported (ROADMAP.md, Queue A)."""

from mmlspark_tpu_torch.io.port_forwarding import PortForwarding, build_forward_command

__all__ = ["PortForwarding", "build_forward_command"]
