"""Feature-name metadata propagation (`Utils.getFeaturesMetadata`,
reference `ensemble/Utils.scala:42-61`); the port's own copy of
``spark_ensemble_tpu/utils/features.py``.

The reference re-indexes DataFrame ``AttributeGroup`` column metadata after
subspace slicing so a base model trained on sliced vectors still reports
meaningful feature names.  The TPU build has no DataFrame metadata; instead a
lightweight ``FeatureMetadata`` record travels with estimators/models (the
``feature_names`` param) and re-indexes itself through subspace masks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class FeatureMetadata:
    """Ordered feature names for a feature matrix's columns."""

    def __init__(self, names: Sequence[str]):
        self.names: List[str] = [str(n) for n in names]

    @classmethod
    def default(cls, num_features: int) -> "FeatureMetadata":
        """Anonymous names, like Spark's unnamed AttributeGroup."""
        return cls([f"f{i}" for i in range(num_features)])

    @classmethod
    def resolve(
        cls, names: Optional[Sequence[str]], num_features: int
    ) -> "FeatureMetadata":
        if names is None:
            return cls.default(num_features)
        if len(names) != num_features:
            raise ValueError(
                f"feature_names has {len(names)} entries for "
                f"{num_features} features"
            )
        return cls(names)

    def __len__(self) -> int:
        return len(self.names)

    def __eq__(self, other) -> bool:
        return isinstance(other, FeatureMetadata) and self.names == other.names

    def select(self, mask_or_indices) -> "FeatureMetadata":
        """Names of a feature subspace — the re-indexing the reference does
        after ``slice()`` (`Utils.scala:42-61`).  Accepts a boolean mask
        (subspace mask) or an index array."""
        arr = np.asarray(mask_or_indices)
        if arr.dtype == bool:
            if arr.shape[0] != len(self.names):
                raise ValueError(
                    f"mask length {arr.shape[0]} != {len(self.names)} features"
                )
            idx = np.nonzero(arr)[0]
        else:
            idx = arr.astype(np.int64)
        return FeatureMetadata([self.names[int(i)] for i in idx])

    def __repr__(self):
        return f"FeatureMetadata({self.names!r})"
