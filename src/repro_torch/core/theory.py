"""Analytic results of paper §VI: convergence bounds and time-efficiency.

Pure functions over floats, copied from the JAX package so that both give
the same answers: used by ``examples/torch_femnist_e2e.py`` (the Prop. 4
line) and, fed with the CLI's ``--log-json`` byte ledger (``bytes_int``,
``bytes_ext``), the §18.4 measured-bytes crossover
(:func:`measured_crossover`). ``NetworkModel.t_select`` is the paper's
15 ms, a constant of the model, not a measurement of this port.
"""
from __future__ import annotations

import dataclasses
import math


def h(T: float, eta: float, beta: float) -> float:
    """h(T) = (1/β)((ηβ+1)^T − 1) − ηT  (Prop. 3). h(1)=0, grows with T."""
    return ((eta * beta + 1.0) ** T - 1.0) / beta - eta * T


def convergence_upper_bound(T: int, R: int, *, eta: float, beta: float,
                            rho: float, delta: float, varphi: float,
                            epsilon: float) -> float:
    """Prop. 3: L(ω_TR) − L(ω*) ≤ 1 / (TR(ηφ − ρδh(T)/(Tε²))).

    Raises ``ValueError`` when the denominator is non-positive — there the
    proposition's premise (η small enough that the descent term dominates
    the drift term) fails and the bound is vacuous. Returning ``inf``
    silently, as this used to, let sweeps average a vacuous point into
    real ones.
    """
    denom = T * R * (eta * varphi - rho * delta * h(T, eta, beta) / (T * epsilon ** 2))
    if denom <= 0:
        raise ValueError(
            f"Prop. 3 premise violated (denominator {denom:.3g} <= 0): "
            "eta too large for (beta, rho, delta, epsilon) — the bound is "
            "vacuous at these constants")
    return 1.0 / denom


def optimality_gap_bound(T: int, R: int, *, eta: float, beta: float,
                         rho: float, delta: float, varphi: float) -> float:
    """Prop. 3 (relaxed form, requires η ≤ 1/β):
    G ≤ 1/(ηφTR) + ρδh(T) + sqrt(ρδh(T)/(ηφT))."""
    assert eta <= 1.0 / beta + 1e-12, "bound requires eta <= 1/beta"
    hT = h(T, eta, beta)
    return (1.0 / (eta * varphi * T * R) + rho * delta * hT
            + math.sqrt(rho * delta * hT / (eta * varphi * T)))


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """§VI.B communication model (Assumption 2 symmetric variant)."""
    model_size_bytes: float = 26.4e6   # S — the paper CNN ≈ 6.6M fp32 params
    b_int: float = 1e9                 # B^int: device<->BS (5G edge), bit/s
    b_ext: float = 50e6                # B^ext: BS<->cloud (WAN), bit/s
    snr: float = 10.0                  # γ (linear); β_link = log2(1+γ)
    t_comp: float = 0.05               # per-local-update compute delay, s
    t_select: float = 0.015            # GBP-CS latency (paper: 15 ms)

    @property
    def beta_link(self) -> float:
        return math.log2(1.0 + self.snr)


def t_fedgs_round(T: int, M: int, L: int, net: NetworkModel) -> float:
    """Eq. (24): T_FEDGS = 2SM/(βB_ext) + T(T_select + 2SL/(βB_int) + T_comp)."""
    s_bits = 8.0 * net.model_size_bytes
    ext = 2.0 * s_bits * M / (net.beta_link * net.b_ext)
    per_iter = (net.t_select + 2.0 * s_bits * L / (net.beta_link * net.b_int)
                + net.t_comp)
    return ext + T * per_iter


def t_fedavg_round(T: int, M: int, L: int, net: NetworkModel) -> float:
    """Eq. (25): T_FedAvg = 2SML/(βB_ext) + T·T_comp."""
    s_bits = 8.0 * net.model_size_bytes
    return 2.0 * s_bits * M * L / (net.beta_link * net.b_ext) + T * net.t_comp


def efficiency_condition(T: int, M: int, L: int, net: NetworkModel) -> bool:
    """Prop. 4 (with T_select ≈ 0): FEDGS faster iff TL/(M(L−1)) < B_int/B_ext.

    L=1 (one device per group) degenerates: FEDGS moves the same external
    traffic as FedAvg *plus* T internal rounds, so it can never win on
    time — the condition is False, not a ZeroDivisionError."""
    if L <= 1:
        return False
    return (T * L) / (M * (L - 1)) < net.b_int / net.b_ext


def efficiency_condition_exact(T: int, M: int, L: int,
                               net: NetworkModel) -> bool:
    """Exact inequality before the T_select≈0 relaxation (Proof 4):
    (B_ext/B_int)·S·L + T_select·β·B_ext/2 < S·M·(L−1)/T  (S in bits).
    At L=1 the right side is 0 < lhs, so the condition is False — same
    degenerate verdict as :func:`efficiency_condition`, no special case."""
    s_bits = 8.0 * net.model_size_bytes
    lhs = (net.b_ext / net.b_int) * s_bits * L \
        + net.t_select * net.beta_link * net.b_ext / 2.0
    rhs = s_bits * M * (L - 1) / T
    return lhs < rhs


# ---------------------------------------------------------------------------
# §18.4: the measured-bytes crossover — Prop. 4 fed with what the engine
# actually transmitted instead of the dense 2S analytic payloads.
# ---------------------------------------------------------------------------

def t_round_measured(bytes_int: float, bytes_ext: float, T: int, M: int,
                     net: NetworkModel, *, select: bool = True) -> float:
    """Eq. (24) generalized to a measured byte ledger (DESIGN.md §18.4).

    ``bytes_ext`` crosses the shared BS↔cloud link at ``B_ext``;
    ``bytes_int`` is the ROUND TOTAL over all M base stations, each serving
    its own devices over a private ``B_int`` link in parallel — hence the
    /M, which is exactly how Eq. (24) gets ``2SL/(βB_int)`` without an M.
    With dense payloads (``bytes_ext = 2·S·M``, ``bytes_int = 2·S·L·T·M``)
    this IS :func:`t_fedgs_round`; with ``bytes_int=0, select=False`` it is
    :func:`t_fedavg_round`. Compression shrinks the byte terms and leaves
    the T·(t_select + t_comp) floor alone."""
    t_sel = net.t_select if select else 0.0
    return (8.0 * bytes_ext / (net.beta_link * net.b_ext)
            + 8.0 * (bytes_int / M) / (net.beta_link * net.b_int)
            + T * (t_sel + net.t_comp))


@dataclasses.dataclass(frozen=True)
class CrossoverReport:
    """Predicted-vs-measured Prop. 4 verdict (see :func:`measured_crossover`).

    ``*_ratio`` are thresholds on r = B_int/B_ext: FEDGS is the faster
    system exactly when r exceeds the ratio. ``predicted_ratio`` is the
    relaxed Prop. 4 constant TL/(M(L−1)) (inf at L=1, where FEDGS cannot
    win); ``measured_ratio`` solves the same tie equation with the
    *measured* bytes-per-round and rounds-to-target of each system (inf
    when FedAvg wins at every finite r — e.g. FEDGS needed too many
    rounds). The ``*_s`` fields evaluate both systems' wall-clock at the
    model's own B_int/B_ext for reference."""
    predicted_ratio: float
    measured_ratio: float
    fedgs_round_s: float
    fedavg_round_s: float
    fedgs_total_s: float
    fedavg_total_s: float
    fedgs_wins: bool


def measured_crossover(*, bytes_int_g: float, bytes_ext_g: float,
                       rounds_g: float, bytes_ext_a: float, rounds_a: float,
                       T: int, M: int, L: int, net: NetworkModel,
                       bytes_int_a: float = 0.0) -> CrossoverReport:
    """Prop. 4 with the engine's own numbers (DESIGN.md §18.4).

    Inputs are per-round byte ledgers (``RoundRecord.bytes_int`` /
    ``bytes_ext``, FEDGS ``_g`` / FedAvg ``_a``) and each system's measured
    rounds-to-target-accuracy. Holding ``net.b_ext`` fixed and sweeping
    r = B_int/B_ext, FEDGS's total wall clock

        R_g · (8·E_g/(βB_ext) + 8·(I_g/M)/(β·r·B_ext) + T(t_sel + t_comp))

    falls in r while FedAvg's is flat, so the tie point is closed-form:

        r* = R_g·8·(I_g/M) / (βB_ext · gap),
        gap = T_a^total − R_g·(8·E_g/(βB_ext) + T(t_sel + t_comp))

    with r* = inf when gap ≤ 0 (FEDGS loses even with a free internal
    link). With dense payloads, equal rounds and t_select = 0 this
    reduces to the relaxed constant TL/(M(L−1)) *exactly* — the algebra
    the round-trip test pins."""
    beta = net.beta_link
    t_g_round = t_round_measured(bytes_int_g, bytes_ext_g, T, M, net)
    t_a_round = t_round_measured(bytes_int_a, bytes_ext_a, T, M, net,
                                 select=False)
    t_g_total = rounds_g * t_g_round
    t_a_total = rounds_a * t_a_round
    predicted = math.inf if L <= 1 else (T * L) / (M * (L - 1))
    gap = t_a_total - rounds_g * (
        8.0 * bytes_ext_g / (beta * net.b_ext)
        + T * (net.t_select + net.t_comp))
    if gap <= 0:
        measured = math.inf
    else:
        measured = rounds_g * 8.0 * (bytes_int_g / M) / (
            beta * net.b_ext * gap)
    return CrossoverReport(
        predicted_ratio=predicted, measured_ratio=measured,
        fedgs_round_s=t_g_round, fedavg_round_s=t_a_round,
        fedgs_total_s=t_g_total, fedavg_total_s=t_a_total,
        fedgs_wins=t_g_total < t_a_total)
