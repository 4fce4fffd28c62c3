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
  ``max_retries``) and the ``SE_TPU_CHAOS`` fault injector;
- the out-of-core data plane: ``write_shards`` / ``ShardStore`` (the JAX
  package's shard format, either way), ``ShardPrefetcher``, and
  ``fit_streaming`` on the GBM estimators, bit-identical to a resident
  ``hist="stream"`` fit;
- autotuning: ``TUNABLES`` (the hot path's constants, the CUDA kernels'
  plan sizes among them), a measured search (``run_search``,
  ``autotune_fit``, ``tools/autotune_torch.py``) whose winners a
  ``TuningCache`` keeps per card and shape class and every site reads
  (``SE_TPU_AUTOTUNE=off|cache|search``), and the kernels' build cache
  (``enable_compilation_cache``, ``SE_TPU_COMPILE_CACHE``);
- packed export: ``pack`` / ``PackedModel`` / ``load_packed`` (the JAX
  package's artifact, either way) and ``serving.fit_resume``;
- the serving engine ``InferenceEngine`` (one CUDA graph per bucket,
  micro-batching, prefix tiers, on-device drift sketches);
- the closed serving loop: ``ModelRegistry`` (LRU eviction of device
  memory, pin-until-reply leases), ``FleetRouter`` (replicated engines,
  breakers, hedging, prefix degradation, torn-free swaps, elastic width),
  ``Watchdog``, ``ShadowScorer`` and ``Autopilot`` (scaling, warm-start
  refresh fits, rollback);
- distribution: ``fit(X, y, mesh=...)`` on GBM, Bagging, Boosting,
  Stacking, the tuners, ``Pipeline``, the megabatch sweep and the base
  learners (checkpoints too), one process per device over
  ``torch.distributed`` (``parallel``: ``multihost.initialize``,
  ``data_member_mesh``, ``hybrid_data_member_mesh``), and the elastic shard
  sweep ``fit_streaming(mesh=...)`` with ``ElasticCoordinator``, which
  absorbs a lost rank and resumes bit-identically;
- telemetry: ``telemetry_path`` / ``SE_TPU_TELEMETRY`` / ``record_fits``
  event streams in the JAX package's schema, ``fit_history_``, trace
  spans, the metrics registry, ``DriftMonitor``, and ``profile_dir``
  captures summarized by ``utils/profiling.py``;
- the operator plane: ``start_operator_plane`` / ``OperatorPlane``
  (``/metrics``, ``/statusz``, ``/programz``, ``/healthz``, ``/qualityz``
  over the program inventory ``ProgramInventory``, whose rows carry each
  program's and each CUDA kernel's launch work, and ``HbmSampler``),
  ``render_openmetrics`` / ``validate_openmetrics``, and pod-scope
  stitching of per-rank streams (``stitch_files``, ``skew_report``).

The level histograms, routes and leaf sums of the ``pallas`` and ``fused``
tiers run as hand-written CUDA kernels (``csrc/hist.cu``) built with
``nvcc`` at first use.  The package imports torch and numpy, never jax or
the JAX package.  ROADMAP.md's queues list what is still to port.
"""

__version__ = "0.1.0"

from spark_ensemble_tpu_torch.autotune import (
    TUNABLES,
    TuningCache,
    autotune_fit,
    enable_compilation_cache,
    run_search,
)
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
from spark_ensemble_tpu_torch.execution import (
    RoundExecutor,
    device_patience_enabled,
    resolve_pipeline_depth,
)
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
from spark_ensemble_tpu_torch.data import (
    DEFAULT_PREFETCH_DEPTH,
    DEFAULT_SHARD_ROWS,
    SHARD_FORMAT,
    PartitionedShardReader,
    ShardLoadError,
    ShardPartition,
    ShardPrefetcher,
    ShardStore,
    manifest_digest,
    partition_shards,
    write_shards,
)
from spark_ensemble_tpu_torch.models.base import shared_fit_context
from spark_ensemble_tpu_torch.robustness import (
    ChaosController,
    ChaosPreemption,
    ChaosTransientError,
    NonFiniteError,
    NumericGuard,
    RetryPolicy,
    retry_call,
    validate_fit_inputs,
)
from spark_ensemble_tpu_torch import telemetry
from spark_ensemble_tpu_torch.serving import (
    PACKED_FORMAT_VERSION,
    Autopilot,
    FleetOverloadError,
    FleetResponse,
    FleetRouter,
    InferenceEngine,
    ModelRegistry,
    PackedModel,
    fit_resume,
    load_packed,
    pack,
)
from spark_ensemble_tpu_torch.telemetry import (
    DriftMonitor,
    FitTelemetry,
    FlightRecorder,
    HbmSampler,
    MetricsRegistry,
    OperatorPlane,
    OperatorServer,
    ProgramInventory,
    ProgramRecord,
    ShadowScorer,
    Span,
    TelemetryRecorder,
    TraceContext,
    Tracer,
    Watchdog,
    dump_flight,
    global_inventory,
    record_fits,
    render_openmetrics,
    skew_report,
    staged_attribution,
    start_operator_plane,
    stitch_files,
    trace_annotations_enabled,
    validate_openmetrics,
)
from spark_ensemble_tpu_torch import parallel
from spark_ensemble_tpu_torch.parallel import (
    DistributedSweep,
    ElasticCoordinator,
    HostLostError,
    slice_count,
    survivor_mesh,
)
from spark_ensemble_tpu_torch.utils.checkpoint import TrainingCheckpointer
from spark_ensemble_tpu_torch.utils.features import FeatureMetadata
from spark_ensemble_tpu_torch.utils.persist import load, save
from spark_ensemble_tpu_torch.utils.quantile import (
    weighted_median,
    weighted_quantile,
)

__all__ = [
    "Autopilot",
    "BaggingClassificationModel",
    "BaggingClassifier",
    "BaggingRegressionModel",
    "BaggingRegressor",
    "BinaryClassificationEvaluator",
    "BoostingClassificationModel",
    "BoostingClassifier",
    "BoostingRegressionModel",
    "BoostingRegressor",
    "ChaosController",
    "ChaosPreemption",
    "ChaosTransientError",
    "CrossValidator",
    "CrossValidatorModel",
    "DEFAULT_PREFETCH_DEPTH",
    "DEFAULT_SHARD_ROWS",
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "DistributedSweep",
    "DriftMonitor",
    "DummyClassificationModel",
    "DummyClassifier",
    "DummyRegressionModel",
    "DummyRegressor",
    "ElasticCoordinator",
    "FeatureMetadata",
    "FitTelemetry",
    "FleetOverloadError",
    "FleetResponse",
    "FleetRouter",
    "FlightRecorder",
    "GBMClassificationModel",
    "GBMClassifier",
    "GBMRegressionModel",
    "GBMRegressor",
    "GaussianNaiveBayes",
    "GaussianNaiveBayesModel",
    "HostLostError",
    "InferenceEngine",
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
    "MetricsRegistry",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "ModelRegistry",
    "MulticlassClassificationEvaluator",
    "NonFiniteError",
    "NumericGuard",
    "PACKED_FORMAT_VERSION",
    "PackedModel",
    "ParamGridBuilder",
    "PartitionedShardReader",
    "Pipeline",
    "PipelineModel",
    "RegressionEvaluator",
    "RetryPolicy",
    "RoundExecutor",
    "SHARD_FORMAT",
    "ShadowScorer",
    "ShardLoadError",
    "ShardPartition",
    "ShardPrefetcher",
    "ShardStore",
    "Span",
    "StackingClassificationModel",
    "StackingClassifier",
    "StackingRegressionModel",
    "StackingRegressor",
    "StandardScaler",
    "StandardScalerModel",
    "TUNABLES",
    "TelemetryRecorder",
    "TraceContext",
    "Tracer",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
    "TrainingCheckpointer",
    "TuningCache",
    "Watchdog",
    "ProgramInventory",
    "ProgramRecord",
    "HbmSampler",
    "global_inventory",
    "OperatorPlane",
    "OperatorServer",
    "render_openmetrics",
    "start_operator_plane",
    "validate_openmetrics",
    "skew_report",
    "stitch_files",
    "autotune_fit",
    "bagging_classifier_from_arrays",
    "bagging_regressor_from_arrays",
    "boosting_classifier_from_arrays",
    "boosting_regressor_from_arrays",
    "decision_tree_classifier_from_arrays",
    "device_patience_enabled",
    "dump_flight",
    "enable_compilation_cache",
    "fit_resume",
    "fit_sweep",
    "gaussian_nb_from_arrays",
    "gbm_classifier_from_arrays",
    "gbm_regressor_from_arrays",
    "linear_regression_from_arrays",
    "linear_tree_regressor_from_arrays",
    "load",
    "load_packed",
    "logistic_regression_from_arrays",
    "manifest_digest",
    "min_max_scaler_from_arrays",
    "mlp_classifier_from_arrays",
    "mlp_regressor_from_arrays",
    "pack",
    "partition_shards",
    "pipeline_from_models",
    "record_fits",
    "resolve_pipeline_depth",
    "retry_call",
    "run_search",
    "save",
    "shared_fit_context",
    "slice_count",
    "stacking_classifier_from_models",
    "stacking_regressor_from_models",
    "staged_attribution",
    "standard_scaler_from_arrays",
    "survivor_mesh",
    "sweep_group_key",
    "sweep_unsupported_reason",
    "telemetry",
    "trace_annotations_enabled",
    "validate_fit_inputs",
    "weighted_median",
    "weighted_quantile",
    "write_shards",
]
