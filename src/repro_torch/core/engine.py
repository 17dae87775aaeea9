"""The typed per-round log record shared by the host loop and the CLI."""
from __future__ import annotations

import math
from typing import NamedTuple

_NAN = float("nan")


class RoundRecord(NamedTuple):
    """One federated round's log entry (the JAX package's field set).

    ``test_loss``/``test_accuracy`` are None on rounds without eval. The
    telemetry fields are NaN where a run does not report them:
    ``group_discrepancy`` is the mean per-group discrepancy of the groups'
    data distribution vs the global one, ``selection_distance`` the GBP-CS
    objective ``d`` of the last rebuild, ``reselections`` the number of
    GBP-CS rebuilds this round, ``bytes_int`` the round's device↔BS bytes
    (Eq. 4, download + upload per seated contributor over all T
    iterations) and ``bytes_ext`` the BS↔cloud bytes (Eq. 5, 2·payload·M),
    the payload being 4|θ| dense and smaller under §18 compression;
    ``compress_error`` is the mean EF residual norm of a compressed run.
    The availability fields stay NaN on the port's path; the robustness
    fields are set on the robust path.
    """
    round: int
    loss: float
    divergence: float = _NAN
    test_loss: float | None = None
    test_accuracy: float | None = None
    strategy: str = ""
    group_discrepancy: float = _NAN
    selection_distance: float = _NAN
    reselections: float = _NAN
    participation: float = _NAN
    staleness_mean: float = _NAN
    staleness_max: float = _NAN
    dark_selected: float = _NAN
    corrupted_selected: float = _NAN
    clipped_fraction: float = _NAN
    rollbacks: float = _NAN
    agg_residual: float = _NAN
    bytes_int: float = _NAN
    bytes_ext: float = _NAN
    compress_error: float = _NAN

    def to_dict(self) -> dict:
        d = dict(self._asdict())
        for k in _OPTIONAL_METRICS:
            if math.isnan(d[k]):          # runs without the telemetry
                d[k] = None               # (strict-JSON safe, unlike NaN)
        return d


_OPTIONAL_METRICS = ("divergence", "group_discrepancy", "selection_distance",
                     "reselections", "participation", "staleness_mean",
                     "staleness_max", "dark_selected", "corrupted_selected",
                     "clipped_fraction", "rollbacks", "agg_residual",
                     "bytes_int", "bytes_ext", "compress_error")
