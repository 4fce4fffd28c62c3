"""spark_ensemble_tpu_torch: the PyTorch/CUDA port of spark_ensemble_tpu.

This first slice runs the GBM main path — ``GBMClassifier`` (logloss) and
``GBMRegressor`` (squared loss) over a histogram ``DecisionTreeRegressor`` —
fit and predict, on an NVIDIA H100 (``device="cuda"``, the default) or on
the CPU (``device="cpu"``).  The level histograms of the ``pallas`` and
``fused`` tiers run as hand-written CUDA kernels (``csrc/hist.cu``) built
with ``nvcc`` at first use.  The package imports torch and numpy, never
jax or the JAX package.
"""

from spark_ensemble_tpu_torch.convert import (
    gbm_classifier_from_arrays,
    gbm_regressor_from_arrays,
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
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)

__all__ = [
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "DummyClassificationModel",
    "DummyClassifier",
    "DummyRegressionModel",
    "DummyRegressor",
    "GBMClassificationModel",
    "GBMClassifier",
    "GBMRegressionModel",
    "GBMRegressor",
    "gbm_classifier_from_arrays",
    "gbm_regressor_from_arrays",
]
