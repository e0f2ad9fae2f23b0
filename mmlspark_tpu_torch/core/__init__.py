from .params import (Param, Params, TypeConverters, HasFeaturesCol,
                     HasLabelCol, HasPredictionCol, HasProbabilityCol,
                     HasRawPredictionCol, HasWeightCol,
                     HasValidationIndicatorCol)
from .schema import DataTable, to_table, from_table, features_matrix
from .pipeline import (PipelineStage, Transformer, Estimator, Model,
                       Pipeline, PipelineModel)
from .utils import ClusterUtil, FaultToleranceUtils, StopWatch
from .telemetry import (MetricsRegistry, EventJournal, get_registry,
                        get_journal, new_trace_id, render_prometheus,
                        merge_snapshots, read_journal)
from .sketch import (StreamSketch, MatrixSketch, ReferenceProfile,
                     build_reference_profile, merge_sketch_snapshots,
                     psi, js_divergence)
from .drift import (DriftConfig, DriftMonitor, set_drift_monitor,
                    peek_drift_monitor, drift_report_from_counters)

__all__ = [
    "Param", "Params", "TypeConverters", "HasFeaturesCol", "HasLabelCol",
    "HasPredictionCol", "HasProbabilityCol", "HasRawPredictionCol",
    "HasWeightCol", "HasValidationIndicatorCol",
    "DataTable", "to_table", "from_table", "features_matrix",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline",
    "PipelineModel",
    "ClusterUtil", "FaultToleranceUtils", "StopWatch",
    "MetricsRegistry", "EventJournal", "get_registry", "get_journal",
    "new_trace_id", "render_prometheus", "merge_snapshots",
    "read_journal",
    "StreamSketch", "MatrixSketch", "ReferenceProfile",
    "build_reference_profile", "merge_sketch_snapshots",
    "psi", "js_divergence",
    "DriftConfig", "DriftMonitor", "set_drift_monitor",
    "peek_drift_monitor", "drift_report_from_counters",
]
