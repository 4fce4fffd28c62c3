"""The typed tunable space (PyTorch port of ``autotune/space.py``).

The port's hot path runs on constants set by hand: the CUDA kernels' plan
sizes (``ops/hist_kernels.py``), the round chunk and lookahead depth, the
stream tier's chunk, the predict chunk, the sweep's slab and the sampling
floor.  Each gets a name, its shipped default, the candidate grid a
measured search sweeps, and the source site the value feeds, so the
search (``autotune/search.py``), the on-disk cache (``autotune/cache.py``)
and the resolution layer (``autotune/resolve.py``) speak one schema.

The names, kinds and order are the JAX package's 18.  Each default is the
port's own literal at its site: with autotuning off (``SE_TPU_AUTOTUNE=
off``) or no cache entry, ``resolve`` returns the caller's live module
constant and a fit is bit-identical to one without this package.  A
tunable with no site in the port keeps its entry (a cache written by
either package stays readable) with ``site=None`` and a doc that says why.

The four kernel knobs take the card's meaning: on the TPU they were the
Pallas kernels' rows per grid step and VMEM budgets; here they are the
rows ``level_hist`` stages per step (``R``) and the shared-memory bytes of
one CTA's histogram tile, for ``level_hist<2>`` (the pallas tier, i32
bins) and ``level_hist<3>`` (the fused tier, packed bins).  ``R`` is
bit-neutral by construction: the plan takes its row chunking from the
shipped ``R`` (``ops/hist_kernels.py::level_plan``).  A budget retiles the
features and members of a CTA, and with them the row chunking, so it
changes the order of each cell's sum.  The route's and the leaf pass's
plans are not tunable: the JAX package has no knob for them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

KIB = 1024


@dataclass(frozen=True)
class Tunable:
    """One measured knob: name, shipped default, candidate grid, site."""

    name: str
    default: object
    candidates: Tuple[object, ...]
    doc: str
    site: Optional[str]  # "<module>:<constant or function>", None: no site
    kind: str = "int"  # "int" | "choice"

    def validate(self, value) -> bool:
        if self.kind == "choice":
            return value in self.candidates
        return isinstance(value, int) and not isinstance(value, bool) and value > 0


class TunableSpace:
    """Ordered, name-addressable collection of :class:`Tunable`."""

    def __init__(self, tunables: Tuple[Tunable, ...]):
        self._by_name: Dict[str, Tunable] = {}
        for t in tunables:
            if t.name in self._by_name:
                raise ValueError(f"duplicate tunable {t.name!r}")
            self._by_name[t.name] = t

    def __getitem__(self, name: str) -> Tunable:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __iter__(self) -> Iterator[Tunable]:
        return iter(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._by_name)

    def defaults(self) -> Dict[str, object]:
        return {t.name: t.default for t in self}

    def validate_params(self, params: Dict[str, object]) -> Dict[str, object]:
        """Drop unknown names and values of the wrong type (a cache written
        by a newer build degrades to the defaults, never breaks a fit)."""
        out = {}
        for name, value in params.items():
            t = self._by_name.get(name)
            if t is not None and t.validate(value):
                out[name] = value
        return out


_ROWS_DOC = (
    "rows level_hist<{n}> stages per step, R ({tier} tier; halved when a "
    "staged row holds more than _LEVEL_WIDE words).  Bit-neutral: the plan "
    "keeps the shipped R's row chunking, and a cell's sum runs in 32-row "
    "steps from its chunk's start whatever R is.  A value whose tile does "
    "not fit the card's shared memory, or whose staged rows are not a "
    "positive multiple of 32, falls back to the shipped one"
)
_BYTES_DOC = (
    "shared-memory bytes of one CTA's histogram tile of level_hist<{n}> "
    "({tier} tier): the features and members a CTA takes.  It retiles the "
    "level and, with the tiles, the row chunks, so it changes the order of "
    "each cell's f32 sum (a fixed order for a given value).  A value whose "
    "tile does not fit falls back to the shipped one"
)

# the space: each default is the port's literal at its site
TUNABLES = TunableSpace((
    Tunable(
        "scan_chunk", 16, (4, 8, 16, 32, 64, 128),
        doc="rounds per chunk of the GBM and Boosting round loops (the host "
        "reads a chunk's flags and losses at once); a hand-set estimator "
        "param always wins.  The megabatch sweep has no chunk: it runs its "
        "lockstep rounds one at a time",
        site="models/base.py:resolved_scan_chunk",
    ),
    Tunable(
        "stream_chunk_rows", 32768,
        (8192, 16384, 32768, 65536, 131072),
        doc="rows per chunk of the stream histogram tier",
        site="ops/tree.py:_STREAM_CHUNK_ROWS",
    ),
    Tunable(
        "shard_rows", 32768,
        (8192, 16384, 32768, 65536, 131072),
        doc="rows per on-disk shard of the out-of-core data plane; keep "
            "equal to stream_chunk_rows for bit-identity with resident "
            "stream fits",
        site="data/shards.py:DEFAULT_SHARD_ROWS",
    ),
    Tunable(
        "prefetch_depth", 2,
        (1, 2, 3, 4),
        doc="shards kept in flight past the one being consumed by the "
            "streaming fit's prefetcher",
        site="data/prefetch.py:DEFAULT_PREFETCH_DEPTH",
    ),
    Tunable(
        "predict_fused_max_cells", 2**22,
        (2**20, 2**21, 2**22, 2**23, 2**24, 2**25, 2**26),
        doc="rows x trees per chunk of predict_forest's heap walk (bounds "
        "its [rows, trees] id tensors); the JAX package's budget counts "
        "rows x members x leaves of its routing one-hot, so the grid is "
        "the port's own",
        site="ops/tree.py:_PREDICT_MAX_CELLS",
    ),
    Tunable(
        "hist_tier", "auto",
        ("auto", "scatter", "matmul", "stream", "fused"),
        doc="histogram tier taken when the tree's hist param is 'auto'; a "
        "tuned 'fused' past 256 bins falls back to the heuristic",
        site="ops/tree.py:resolve_forest_tier",
        kind="choice",
    ),
    Tunable(
        "pallas_block_rows", 256, (64, 128, 256, 512),
        doc=_ROWS_DOC.format(n=2, tier="pallas"),
        site="ops/hist_kernels.py:_LEVEL_ROWS",
    ),
    Tunable(
        "pallas_vmem_budget", 128 * KIB,
        (64 * KIB, 96 * KIB, 128 * KIB, 160 * KIB),
        doc=_BYTES_DOC.format(n=2, tier="pallas"),
        site="ops/hist_kernels.py:_CTA_HIST_BYTES",
    ),
    Tunable(
        "pack_bits", 0, (0, 4, 8, 32),
        doc="lane width of the fused tier's packed bin words (0 = auto: the "
        "narrowest width max_bins allows; a tuned value never narrows "
        "below that)",
        site="ops/binning.py:pack_width",
        kind="choice",
    ),
    Tunable(
        "fused_block_rows", 256, (64, 128, 256, 512),
        doc=_ROWS_DOC.format(n=3, tier="fused"),
        site="ops/hist_kernels.py:_LEVEL_ROWS",
    ),
    Tunable(
        "fused_vmem_budget", 128 * KIB,
        (64 * KIB, 96 * KIB, 128 * KIB, 160 * KIB),
        doc=_BYTES_DOC.format(n=3, tier="fused"),
        site="ops/hist_kernels.py:_CTA_HIST_BYTES",
    ),
    Tunable(
        "predict_bucket_pow2_exact", 512, (256, 512, 1024, 2048),
        doc="no site in the port: the JAX package pads predict batches to a "
        "bucket ladder so that each bucket traces one program; the port's "
        "predict runs unpadded and traces nothing (the serving engine pads "
        "to its own buckets, one CUDA graph each)",
        site=None,
    ),
    Tunable(
        "predict_bucket_octave_steps", 8, (4, 8, 16),
        doc="no site in the port: the second rung of the JAX package's "
        "predict bucket ladder (see predict_bucket_pow2_exact)",
        site=None,
    ),
    Tunable(
        "pipeline_depth", 1, (0, 1, 2),
        doc="round chunks kept launched past the one being committed "
        "(0 = synchronous; SE_TPU_PIPELINE wins)",
        site="execution.py:resolve_pipeline_depth",
        kind="choice",
    ),
    Tunable(
        "configs_per_dispatch", 32, (8, 16, 32, 64),
        doc="sweep candidates (lanes) fitted as one forest per round; "
        "candidates beyond it run in further slabs",
        site="models/gbm_sweep.py:_CONFIGS_PER_DISPATCH",
    ),
    Tunable(
        "sample_bucket_floor", 256, (64, 128, 256, 512, 1024),
        doc="smallest pow2 row bucket the gradient-based sampling stage "
        "gathers into (GOSS/MVS)",
        site="models/gbm.py:_resolved_sampling",
    ),
    Tunable(
        "goss_top_rate", 0.2, (0.1, 0.2, 0.3),
        doc="fraction of rows kept by |grad| rank when sampling='goss' and "
        "top_rate was left at its default (hand-set rates always win)",
        site="models/gbm.py:_resolved_sampling",
        kind="choice",
    ),
    Tunable(
        "goss_other_rate", 0.1, (0.05, 0.1, 0.2),
        doc="fraction of the remaining rows drawn uniformly when "
        "sampling='goss' and other_rate was left at its default (hand-set "
        "rates always win)",
        site="models/gbm.py:_resolved_sampling",
        kind="choice",
    ),
))


def shape_class(n: Optional[int] = None) -> str:
    """Coarse workload key of the cache: the log2 bucket of the row count
    (``"n14"`` for letter-scale ~16k rows), or ``"*"`` when the site knows
    no row count.  Search results are stored under both the tuned shape's
    class and ``"*"``; lookup overlays the exact class on ``"*"``."""
    if n is None or n <= 0:
        return "*"
    return f"n{round(math.log2(max(int(n), 1)))}"
