"""spark_ensemble_tpu_torch: the PyTorch/CUDA port of spark_ensemble_tpu.

Ported so far, fit and predict on an NVIDIA H100 (``device="cuda"``, the
default) or on the CPU (``device="cpu"``):

- GBM: ``GBMClassifier`` (logloss) and ``GBMRegressor`` (squared loss),
  with uniform row and feature sampling;
- Bagging (SubBag): ``BaggingClassifier`` (hard and soft votes) and
  ``BaggingRegressor``, all members in one forest fit;
- Boosting: ``BoostingClassifier`` (SAMME, SAMME.R) and
  ``BoostingRegressor`` (Drucker R2);
- the base learners ``DecisionTreeRegressor``, ``DecisionTreeClassifier``,
  ``DummyRegressor`` (mean, constant) and ``DummyClassifier``;
- the evaluators behind ``score()``, and ``jax.random``'s draws, bit for
  bit (``utils/random.py``).

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
    gbm_classifier_from_arrays,
    gbm_regressor_from_arrays,
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
from spark_ensemble_tpu_torch.models.tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
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
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
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
    "MulticlassClassificationEvaluator",
    "RegressionEvaluator",
    "bagging_classifier_from_arrays",
    "bagging_regressor_from_arrays",
    "boosting_classifier_from_arrays",
    "boosting_regressor_from_arrays",
    "decision_tree_classifier_from_arrays",
    "gbm_classifier_from_arrays",
    "gbm_regressor_from_arrays",
    "weighted_median",
    "weighted_quantile",
]
