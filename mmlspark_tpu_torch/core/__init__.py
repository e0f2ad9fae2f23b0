from .params import (Param, Params, TypeConverters, HasFeaturesCol,
                     HasLabelCol, HasPredictionCol, HasProbabilityCol,
                     HasRawPredictionCol, HasWeightCol,
                     HasValidationIndicatorCol)
from .schema import DataTable, to_table, from_table, features_matrix
from .pipeline import (PipelineStage, Transformer, Estimator, Model,
                       Pipeline, PipelineModel)

__all__ = [
    "Param", "Params", "TypeConverters", "HasFeaturesCol", "HasLabelCol",
    "HasPredictionCol", "HasProbabilityCol", "HasRawPredictionCol",
    "HasWeightCol", "HasValidationIndicatorCol",
    "DataTable", "to_table", "from_table", "features_matrix",
    "PipelineStage", "Transformer", "Estimator", "Model", "Pipeline",
    "PipelineModel",
]
