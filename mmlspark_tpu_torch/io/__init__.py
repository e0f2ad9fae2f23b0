"""Input and output around the port: the serving plane and the fault
injectors.

The port's copy of the reference's ``io/`` package, for the modules it
holds: the HTTP servers and the exchange (:mod:`.serving`), the
micro-batch engine (:mod:`.scoring`), the framed transport
(:mod:`.transport`) and its raw-float32 wire (:mod:`.wire`), the
predictor fleet (:mod:`.fleet`), the binary datasource (:mod:`.binary`)
and the training and serving fault injectors (:mod:`.chaos`), under the
reference's public names.  Importing it touches no CUDA device: a
scorer runs where its booster lives.
"""

from .serving import (DistributedHTTPServer, HTTPServer,
                      MultiprocessHTTPServer, join_exchange,
                      request_table, reply_from_table, serve_forever)
from .scoring import ColumnPlan, ScoringEngine, WorkerKilled
from .chaos import (ChaosChannel, ChaosPlan, ChaosPredictor, ChaosQueue,
                    ChaosSocket, ChaosTransport, kill_process)
from .transport import (Backpressure, ChecksumError, FrameTooLarge,
                        HandshakeError, TransportClient, TransportConfig,
                        TransportError, TransportServer, parse_address)
from .wire import BinaryReq, WireError
from .fleet import (ConsistentHashRing, PredictorFleet,
                    ShardedPredictor, shard_tree_ranges)
from .binary import BinaryFileReader, read_binary_files

__all__ = [
    "HTTPServer", "DistributedHTTPServer", "MultiprocessHTTPServer",
    "join_exchange", "request_table", "reply_from_table",
    "serve_forever", "ColumnPlan", "ScoringEngine", "WorkerKilled",
    "ChaosChannel", "ChaosPlan", "ChaosPredictor", "ChaosQueue",
    "ChaosSocket", "ChaosTransport", "kill_process",
    "Backpressure", "ChecksumError", "FrameTooLarge", "HandshakeError",
    "TransportClient", "TransportConfig", "TransportError",
    "TransportServer", "parse_address",
    "BinaryReq", "WireError",
    "ConsistentHashRing", "PredictorFleet", "ShardedPredictor",
    "shard_tree_ranges",
    "BinaryFileReader", "read_binary_files",
]
