"""Tables made on the device from the seed, in a few large calls, by the
config's ``data`` entry: ``numeric_features`` standard normal columns,
then a block of one-hot columns per entry of ``one_hot_groups`` (one 1 a
row in each group, uniform), and labels by ``label_rule``:

- ``linear`` (two classes): 1 where ``x . beta / sqrt(d) + noise * e > 0``;
- ``argmax``: the class ``k`` with the largest ``x . C_k + noise * e_k``;

all standard normal.  The rule's ``beta`` or ``C`` is the problem and is
drawn from the config's ``problem_seed``; the rows and ``e`` are drawn
from the run's seed.  So every seed samples fresh rows of one problem,
and the work of a fit does not change with the seed.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def make_table(data: dict, seed: int, device, rows: int = None):
    """``(X f32[n, d], y f32[n])`` for the config's ``data`` entry; ``rows``
    overrides its row count (a test's small table)."""
    n = int(rows if rows is not None else data["rows"])
    g = generator(seed, device)
    problem = generator(int(data["problem_seed"]), device)
    cols = [torch.randn((n, int(data["numeric_features"])), generator=g, device=device)]
    for width in data.get("one_hot_groups", []):
        hot = torch.randint(0, int(width), (n,), generator=g, device=device)
        cols.append(torch.nn.functional.one_hot(hot, int(width)).to(torch.float32))
    X = torch.cat(cols, dim=1).contiguous() if len(cols) > 1 else cols[0]
    d = X.shape[1]
    K = int(data["classes"])
    noise = float(data["label_noise"])
    rule = data["label_rule"]
    if rule == "linear":
        if K != 2:
            raise ValueError("label_rule 'linear' makes two classes")
        beta = torch.randn((d,), generator=problem, device=device)
        z = X @ beta / d ** 0.5 + noise * torch.randn((n,), generator=g, device=device)
        y = (z > 0).to(torch.float32)
    elif rule == "argmax":
        C = torch.randn((K, d), generator=problem, device=device)
        z = X @ C.T + noise * torch.randn((n, K), generator=g, device=device)
        y = torch.argmax(z, dim=1).to(torch.float32)
    else:
        raise ValueError(f"unknown label_rule {rule!r}")
    return X, y
