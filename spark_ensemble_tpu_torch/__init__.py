"""spark_ensemble_tpu_torch: the PyTorch/CUDA port of spark_ensemble_tpu.

Ported so far, fit and predict on an NVIDIA H100 (``device="cuda"``, the
default) or on the CPU (``device="cpu"``):

- GBM: ``GBMClassifier`` (logloss, exponential, bernoulli) and
  ``GBMRegressor`` (squared, absolute, huber, quantile, logcosh,
  scaledlogcosh), with uniform row and feature sampling, gradient row
  sampling (``sampling`` goss/mvs with row compaction, the legacy
  ``sample_method="goss"``) and linear leaves (``leaf_model="linear"``);
- Bagging (SubBag): ``BaggingClassifier`` (hard and soft votes) and
  ``BaggingRegressor``, all members in one forest fit;
- Boosting: ``BoostingClassifier`` (SAMME, SAMME.R) and
  ``BoostingRegressor`` (Drucker R2);
- Stacking: ``StackingClassifier`` (class, raw and proba meta-features)
  and ``StackingRegressor``;
- the base learners ``DecisionTreeRegressor``, ``DecisionTreeClassifier``
  (all four precisions: highest, high, default, pallas; every histogram
  tier, the row-chunked ``stream`` tier included),
  ``LinearTreeRegressor``,
  ``LinearRegression``, ``LogisticRegression`` (newton, lbfgs),
  ``GaussianNaiveBayes``, ``MLPClassifier``, ``MLPRegressor``,
  ``DummyRegressor`` and ``DummyClassifier``; Bagging, Boosting and GBM
  take any of them as members;
- model selection: ``ParamGridBuilder``, ``CrossValidator`` and
  ``TrainValidationSplit`` (weight-mask folds, shared binning, and the
  megabatch GBM sweep ``fit_sweep``), ``Pipeline`` with ``StandardScaler``
  and ``MinMaxScaler``, and ``FeatureMetadata``;
- the evaluators behind ``score()``, and ``jax.random``'s draws, bit for
  bit (``utils/random.py``);
- persistence: ``save``/``load`` (and ``Model.save``) in the JAX package's
  on-disk format, so a model saved by either package loads in the other;
- the round runtime: ``RoundExecutor`` (pipelined round chunks,
  ``SE_TPU_PIPELINE``), ``checkpoint_dir`` checkpoints with
  ``TrainingCheckpointer``, ``fit_resume`` and ``take`` on the GBM and
  Boosting models, the ``on_nonfinite`` recovery policies
  (``NonFiniteError``), retry with backoff (``RetryPolicy``,
  ``max_retries``) and the ``SE_TPU_CHAOS`` fault injector.

The level histograms, routes and leaf sums of the ``pallas`` and ``fused``
tiers run as hand-written CUDA kernels (``csrc/hist.cu``) built with
``nvcc`` at first use.  The package imports torch and numpy, never jax or
the JAX package.  ROADMAP.md's queues list what is still to port.
"""

from spark_ensemble_tpu_torch.convert import (
    bagging_classifier_from_arrays,
    bagging_regressor_from_arrays,
    boosting_classifier_from_arrays,
    boosting_regressor_from_arrays,
    decision_tree_classifier_from_arrays,
    gaussian_nb_from_arrays,
    gbm_classifier_from_arrays,
    gbm_regressor_from_arrays,
    linear_regression_from_arrays,
    linear_tree_regressor_from_arrays,
    logistic_regression_from_arrays,
    min_max_scaler_from_arrays,
    mlp_classifier_from_arrays,
    mlp_regressor_from_arrays,
    pipeline_from_models,
    stacking_classifier_from_models,
    stacking_regressor_from_models,
    standard_scaler_from_arrays,
)
from spark_ensemble_tpu_torch.execution import RoundExecutor
from spark_ensemble_tpu_torch.evaluation import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from spark_ensemble_tpu_torch.models.bagging import (
    BaggingClassificationModel,
    BaggingClassifier,
    BaggingRegressionModel,
    BaggingRegressor,
)
from spark_ensemble_tpu_torch.models.boosting import (
    BoostingClassificationModel,
    BoostingClassifier,
    BoostingRegressionModel,
    BoostingRegressor,
)
from spark_ensemble_tpu_torch.models.dummy import (
    DummyClassificationModel,
    DummyClassifier,
    DummyRegressionModel,
    DummyRegressor,
)
from spark_ensemble_tpu_torch.models.gbm import (
    GBMClassificationModel,
    GBMClassifier,
    GBMRegressionModel,
    GBMRegressor,
)
from spark_ensemble_tpu_torch.models.linear import (
    LinearRegression,
    LinearRegressionModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_ensemble_tpu_torch.models.gbm_sweep import (
    fit_sweep,
    sweep_group_key,
    sweep_unsupported_reason,
)
from spark_ensemble_tpu_torch.models.linear_tree import (
    LinearTreeRegressionModel,
    LinearTreeRegressor,
)
from spark_ensemble_tpu_torch.models.mlp import (
    MLPClassificationModel,
    MLPClassifier,
    MLPRegressionModel,
    MLPRegressor,
)
from spark_ensemble_tpu_torch.models.naive_bayes import (
    GaussianNaiveBayes,
    GaussianNaiveBayesModel,
)
from spark_ensemble_tpu_torch.models.stacking import (
    StackingClassificationModel,
    StackingClassifier,
    StackingRegressionModel,
    StackingRegressor,
)
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
from spark_ensemble_tpu_torch.pipeline import (
    MinMaxScaler,
    MinMaxScalerModel,
    Pipeline,
    PipelineModel,
    StandardScaler,
    StandardScalerModel,
)
from spark_ensemble_tpu_torch.tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from spark_ensemble_tpu_torch.robustness.guards import NonFiniteError
from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy
from spark_ensemble_tpu_torch.utils.checkpoint import TrainingCheckpointer
from spark_ensemble_tpu_torch.utils.features import FeatureMetadata
from spark_ensemble_tpu_torch.utils.persist import load, save
from spark_ensemble_tpu_torch.utils.quantile import (
    weighted_median,
    weighted_quantile,
)

__all__ = [
    "BaggingClassificationModel",
    "BaggingClassifier",
    "BaggingRegressionModel",
    "BaggingRegressor",
    "BinaryClassificationEvaluator",
    "BoostingClassificationModel",
    "BoostingClassifier",
    "BoostingRegressionModel",
    "BoostingRegressor",
    "CrossValidator",
    "CrossValidatorModel",
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "DummyClassificationModel",
    "DummyClassifier",
    "DummyRegressionModel",
    "DummyRegressor",
    "FeatureMetadata",
    "GBMClassificationModel",
    "GBMClassifier",
    "GBMRegressionModel",
    "GBMRegressor",
    "GaussianNaiveBayes",
    "GaussianNaiveBayesModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LinearTreeRegressionModel",
    "LinearTreeRegressor",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MLPClassificationModel",
    "MLPClassifier",
    "MLPRegressionModel",
    "MLPRegressor",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "MulticlassClassificationEvaluator",
    "NonFiniteError",
    "ParamGridBuilder",
    "Pipeline",
    "PipelineModel",
    "RegressionEvaluator",
    "RetryPolicy",
    "RoundExecutor",
    "StackingClassificationModel",
    "StackingClassifier",
    "StackingRegressionModel",
    "StackingRegressor",
    "StandardScaler",
    "StandardScalerModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
    "TrainingCheckpointer",
    "bagging_classifier_from_arrays",
    "bagging_regressor_from_arrays",
    "boosting_classifier_from_arrays",
    "boosting_regressor_from_arrays",
    "decision_tree_classifier_from_arrays",
    "fit_sweep",
    "gaussian_nb_from_arrays",
    "gbm_classifier_from_arrays",
    "gbm_regressor_from_arrays",
    "linear_regression_from_arrays",
    "linear_tree_regressor_from_arrays",
    "load",
    "logistic_regression_from_arrays",
    "min_max_scaler_from_arrays",
    "mlp_classifier_from_arrays",
    "mlp_regressor_from_arrays",
    "pipeline_from_models",
    "save",
    "stacking_classifier_from_models",
    "stacking_regressor_from_models",
    "standard_scaler_from_arrays",
    "sweep_group_key",
    "sweep_unsupported_reason",
    "weighted_median",
    "weighted_quantile",
]
