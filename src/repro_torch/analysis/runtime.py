"""Runtime audit backing the ``frozen-mutation`` lint rule.

The static rule catches *source* that writes into compiled-trace
columns; this module checks the *object*: after `CompiledTrace.freeze`
(including `relocate`/`concat` outputs and `SegmentCache` hits) every
op-column array must report ``writeable=False``.  Tests run it over
freshly compiled, concatenated, and relocated traces so a regression in
any freeze path fails loudly instead of corrupting a shared trace.
"""

from __future__ import annotations

import numpy as np

#: CompiledTrace op-column attribute names (mirrors rules.COLUMN_FIELDS;
#: kept literal here so the runtime audit has no import-order coupling
#: with the AST layer)
COLUMN_FIELDS = ("codes", "rids", "concs", "hints", "fargs", "boundaries",
                 "touch_pos_np", "touch_rid_np", "seg_bounds")


def frozen_violations(ct) -> list[str]:
    """Column names of ``ct`` that are missing, non-array, or writeable.

    ``seg_bounds`` is optional (None outside concat mega-traces); every
    other column must be a read-only ndarray.
    """
    bad: list[str] = []
    for field in COLUMN_FIELDS:
        arr = getattr(ct, field, None)
        if arr is None:
            if field != "seg_bounds":
                bad.append(f"{field}: missing")
            continue
        if not isinstance(arr, np.ndarray):
            bad.append(f"{field}: not an ndarray ({type(arr).__name__})")
        elif arr.flags.writeable:
            bad.append(f"{field}: writeable=True after freeze")
    return bad


def assert_frozen(ct, where: str = "trace") -> None:
    """Raise ``AssertionError`` naming every unfrozen column of ``ct``."""
    bad = frozen_violations(ct)
    if bad:
        raise AssertionError(
            f"frozen-column audit failed for {where}: " + "; ".join(bad))
