"""IO layer of the port: HTTP on DataFrames, binary/image ingestion,
writers, with every name of the JAX package's ``io`` ``__all__``.

The HTTP request/response structs (:mod:`http_schema`), the HTTP send and
its retry handlers (:mod:`clients`), which the registry and the elastic
gang speak over, the request/response parsers (:mod:`parsers`), the
bounded-concurrency :class:`HTTPTransformer` and the one-stop
:class:`SimpleHTTPTransformer` (:mod:`http_transformer`), lazily built
per-process objects (:mod:`shared`), the PowerBI-style POST writer
(:mod:`powerbi`), the SSH reverse forward a serving worker can open for
its port (:mod:`port_forwarding`), the CSV loader on the native parser
(:mod:`csv`), binary and image file readers (:mod:`binary`), the
out-of-core :class:`StreamingDataFrame` (:mod:`stream`) that the elastic
gang's ``stream-csv:`` spec reads through, and the
:class:`PartitionConsolidator` (:mod:`consolidator`). All of it is host
code."""

from mmlspark_tpu_torch.io.http_schema import (
    HTTPRequestData,
    HTTPResponseData,
    string_to_response,
)
from mmlspark_tpu_torch.io.shared import SharedSingleton, SharedVariable
from mmlspark_tpu_torch.io.clients import AdvancedHandler, BasicHandler, send_request
from mmlspark_tpu_torch.io.parsers import (
    CustomInputParser,
    CustomOutputParser,
    JSONInputParser,
    JSONOutputParser,
    StringOutputParser,
)
from mmlspark_tpu_torch.io.http_transformer import HTTPTransformer, SimpleHTTPTransformer
from mmlspark_tpu_torch.io.powerbi import PowerBIWriter
from mmlspark_tpu_torch.io.port_forwarding import PortForwarding, build_forward_command
from mmlspark_tpu_torch.io.binary import read_binary_files, read_images
from mmlspark_tpu_torch.io.consolidator import PartitionConsolidator
from mmlspark_tpu_torch.io.csv import read_csv
from mmlspark_tpu_torch.io.stream import StreamingDataFrame

__all__ = [
    "read_csv",
    "read_binary_files",
    "read_images",
    "PartitionConsolidator",
    "StreamingDataFrame",
    "HTTPRequestData",
    "HTTPResponseData",
    "string_to_response",
    "SharedVariable",
    "SharedSingleton",
    "JSONInputParser",
    "JSONOutputParser",
    "StringOutputParser",
    "CustomInputParser",
    "CustomOutputParser",
    "HTTPTransformer",
    "SimpleHTTPTransformer",
    "PowerBIWriter",
    "BasicHandler",
    "AdvancedHandler",
    "send_request",
    "PortForwarding",
    "build_forward_command",
]
