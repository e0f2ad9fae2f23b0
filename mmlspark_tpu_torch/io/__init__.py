"""Input and output around the port: the serving plane, the model
lifecycle and the fault injectors.

The port's copy of the reference's ``io/`` package, for the modules it
holds: the HTTP servers and the exchange (:mod:`.serving`), the
micro-batch engine (:mod:`.scoring`), the framed transport
(:mod:`.transport`) and its raw-float32 wire (:mod:`.wire`), the
predictor fleet (:mod:`.fleet`), the binary datasource (:mod:`.binary`),
the model lifecycle — the versioned registry (:mod:`.registry`), the
SLO-gated rollout (:mod:`.rollout`), the streaming ingest
(:mod:`.ingest`) and the drift-triggered refresh (:mod:`.refresh`) — and
the training, serving and drift fault injectors (:mod:`.chaos`), under
the reference's public names.  Importing it touches no CUDA device: a
scorer runs where its booster lives, and the lifecycle's loads and fits
run on the device their caller names.
"""

from .serving import (DistributedHTTPServer, HTTPServer,
                      MultiprocessHTTPServer, join_exchange,
                      request_table, reply_from_table, serve_forever)
from .scoring import ColumnPlan, ScoringEngine, WorkerKilled
from .chaos import (ChaosChannel, ChaosDrift, ChaosPlan, ChaosPredictor,
                    ChaosQueue, ChaosSocket, ChaosTransport, kill_process)
from .transport import (Backpressure, ChecksumError, FrameTooLarge,
                        HandshakeError, TransportClient, TransportConfig,
                        TransportError, TransportServer, parse_address)
from .wire import BinaryReq, WireError
from .fleet import (ConsistentHashRing, PredictorFleet,
                    ShardedPredictor, shard_tree_ranges)
from .registry import ModelCorruption, ModelRegistry, RegistryError
from .rollout import RolloutConfig, RolloutController
from .ingest import IngestBuffer, IngestError
from .refresh import RefreshConfig, RefreshController, RefreshError
from .binary import BinaryFileReader, read_binary_files

__all__ = [
    "HTTPServer", "DistributedHTTPServer", "MultiprocessHTTPServer",
    "join_exchange", "request_table", "reply_from_table",
    "serve_forever", "ColumnPlan", "ScoringEngine", "WorkerKilled",
    "ChaosChannel", "ChaosDrift", "ChaosPlan", "ChaosPredictor",
    "ChaosQueue", "ChaosSocket", "ChaosTransport", "kill_process",
    "Backpressure", "ChecksumError", "FrameTooLarge", "HandshakeError",
    "TransportClient", "TransportConfig", "TransportError",
    "TransportServer", "parse_address",
    "BinaryReq", "WireError",
    "ConsistentHashRing", "PredictorFleet", "ShardedPredictor",
    "shard_tree_ranges",
    "ModelCorruption", "ModelRegistry", "RegistryError",
    "RolloutConfig", "RolloutController",
    "IngestBuffer", "IngestError",
    "RefreshConfig", "RefreshController", "RefreshError",
    "BinaryFileReader", "read_binary_files",
]
