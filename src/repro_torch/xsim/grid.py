"""Scenario-grid construction and the fleet sweep runner (port of
``repro.xsim.grid``).

A grid cell is (center × scale × workflow × policy); a scenario is a cell
plus a seed drawing its background workload. All cell parameters are
stacked tensors, so ``build_batch`` materialises the whole fleet's job
tables at once (drawing from the port's own threefry stream) and
``events.sweep`` runs them as one batch.

The background generator mirrors ``QueueSim``'s calibrated model
(Poisson bursts, log-normal widths and durations, warm-start residuals
and backlog). Its draws take XLA's float32 ``exp``, ``log``, ``log1p``
and prefix sum (``core.xla_f32``) and the fused multiply-adds XLA makes
of the reference's jitted build (``prng.normal_affine``, the pilot's
duration and waste), so the port's tables are bitwise the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import asa, prng, xla_f32
from repro_torch.device import DEFAULT_DEVICE, check_device, resolve_device
from repro_torch.launch.mesh import make_scenarios_mesh
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import FaultSchedule
from repro_torch.sched.centers import CENTERS, CenterProfile
from repro_torch.sched.strategies import PILOT_STARTUP_S, PILOT_TASK_LATENCY_S
from repro_torch.sched.workflows import WORKFLOWS, Workflow
from repro_torch.xsim import backfill, compare, events, policies
from repro_torch.xsim.state import (ASA_NAIVE, BIGJOB, INVALID, PENDING, PILOT,
                                    POLICY_NAMES, QUEUED, RL, RL_FEATURES,
                                    RUNNING, ScenarioState)

_INF = float("inf")


class XCenter(NamedTuple):
    """Center parameters as data: float32 tensors, ``()`` or ``(B,)``."""

    total_cores: torch.Tensor
    bg_arrival_rate: torch.Tensor
    bg_cores_mean: torch.Tensor
    bg_cores_sigma: torch.Tensor
    bg_duration_mean_s: torch.Tensor
    bg_duration_sigma: torch.Tensor
    bg_backlog: torch.Tensor
    bg_burst_mean: torch.Tensor


def _center_values(p: CenterProfile, shrink: float) -> tuple[float, ...]:
    return (max(p.total_cores * shrink, 8.0), p.bg_arrival_rate * shrink,
            p.bg_cores_mean, p.bg_cores_sigma, p.bg_duration_mean_s,
            p.bg_duration_sigma, max(round(p.bg_initial_backlog * shrink), 1),
            p.bg_burst_mean)


def center_params(p: CenterProfile, shrink: float = 1.0, *,
                  device: str | torch.device = DEFAULT_DEVICE) -> XCenter:
    """A (possibly miniaturised) center. ``shrink`` scales the machine,
    the backlog and the arrival rate together, preserving offered load."""
    dev = resolve_device(device)
    return XCenter(*(torch.tensor(v, dtype=torch.float32, device=dev)
                     for v in _center_values(p, shrink)))


@dataclass(frozen=True)
class XSimConfig:
    """Static shape/budget parameters shared by a whole grid (the
    reference's fields and defaults)."""

    n_warm: int = 48         # warm-start running-job slots
    n_backlog: int = 32      # queued-backlog slots
    n_arrivals: int = 64     # future background-arrival slots
    max_stages: int = 9      # Montage has 9
    t0: float = 7200.0       # workflow submission epoch
    horizon: float = 10 * 86400.0  # arrivals beyond this are dropped
    warm_fill: float = 0.97  # warm-start capacity target
    pred_mode: str = "greedy"  # cascade a_y: live MAP or line-4 draw
    chunk_steps: int = 8     # steps between drain-exit checks
    trace_capacity: int = 0  # event-ring slots per scenario; 0 = untraced
    n_faults: int = 0        # capacity-fault slots per scenario; 0 elides
    #   the fault machinery from the swept program

    def __post_init__(self) -> None:
        if self.pred_mode not in ("greedy", "sample"):
            raise ValueError(f"unknown pred_mode {self.pred_mode!r}")
        if self.chunk_steps < 0:
            raise ValueError(f"chunk_steps must be >= 0, got "
                             f"{self.chunk_steps}")
        if self.trace_capacity < 0:
            raise ValueError(f"trace_capacity must be >= 0, got "
                             f"{self.trace_capacity}")
        if self.n_faults < 0:
            raise ValueError(f"n_faults must be >= 0, got {self.n_faults}")

    @property
    def max_jobs(self) -> int:
        return self.n_warm + self.n_backlog + self.n_arrivals + self.max_stages

    def with_trace(self, capacity: int | None = None) -> "XSimConfig":
        """This config with event tracing on. The default capacity,
        4·max_jobs, covers the worst event sequence a scenario can emit
        (submit, start and finish a job, plus the naive cancel/resubmit
        detours) with slack, so rings normally never overflow."""
        if capacity is None:
            capacity = 4 * self.max_jobs
        elif capacity < 1:
            # an explicit "trace with no room" is a contradiction, not a
            # request to disable tracing (that is the default config)
            raise ValueError(f"with_trace needs trace_capacity >= 1, "
                             f"got {capacity}")
        return dataclasses.replace(self, trace_capacity=capacity)

    @property
    def n_steps(self) -> int:
        """Safe event budget: one admission and one completion step per
        job, plus the naive cancel/resubmit slack and a base cushion, plus
        the capacity-fault term (the reference's formula)."""
        return (2 * self.max_jobs + 2 * self.max_stages + 16
                + self.n_faults * (1 + self.max_jobs))


def build_batch(keys: torch.Tensor, center: XCenter, wf_cores: torch.Tensor,
                wf_durs: torch.Tensor, wf_valid: torch.Tensor,
                est: asa.ASAState, policy: torch.Tensor,
                fault_t: torch.Tensor, fault_c: torch.Tensor,
                fault_k: torch.Tensor, cfg: XSimConfig) -> ScenarioState:
    """B scenarios as a pure function of (keys, cell data): ``keys`` is
    ``(B, 2)``, center fields and ``policy`` are ``(B,)``, stage data
    ``(B, max_stages)``, ``est`` the ``(B,)``-batched live estimators and
    the fault arrays ``(B, n_faults)``. ``cfg.trace_capacity > 0``
    attaches an event ring to each scenario, on the keys' device."""
    dev = keys.device
    b = keys.shape[0]
    ks = prng.split(keys, 9)
    (k_warm_c, k_warm_d, k_warm_u, k_back_c, k_back_d, k_arr_g, k_arr_b,
     k_arr_c, k_arr_d) = (ks[:, i] for i in range(9))
    total = center.total_cores

    def col(x: torch.Tensor) -> torch.Tensor:
        return x.unsqueeze(1)

    one = torch.ones((), dtype=torch.float32, device=dev)

    def widths(k: torch.Tensor, n: int) -> torch.Tensor:
        w = xla_f32.exp(prng.normal_affine(k, (n,), col(center.bg_cores_mean),
                                           col(center.bg_cores_sigma)))
        hi = col(torch.maximum(torch.floor_divide(total, 2.0), one))
        return torch.minimum(torch.maximum(torch.round(w), one), hi)

    def durations(k: torch.Tensor, n: int) -> torch.Tensor:
        d = xla_f32.exp(prng.normal_affine(
            k, (n,), col(center.bg_duration_mean_s),
            col(center.bg_duration_sigma)))
        return torch.clamp(d, 30.0, 7.0 * 86400.0)

    # --- warm start: machine filled to ~warm_fill with residual jobs ------
    wc = widths(k_warm_c, cfg.n_warm)
    wd = durations(k_warm_d, cfg.n_warm)
    w_ok = torch.cumsum(wc, dim=1) <= col(cfg.warm_fill * total)
    wc = torch.where(w_ok, wc, 0.0)
    w_end = prng.uniform(k_warm_u, (cfg.n_warm,), 0.05, 1.0) * wd
    free = total - wc.sum(dim=1)

    # --- backlog: queued at t=0, FCFS position = row order ----------------
    bc = widths(k_back_c, cfg.n_backlog)
    bd = durations(k_back_d, cfg.n_backlog)
    b_ok = (torch.arange(cfg.n_backlog, device=dev).unsqueeze(0)
            < col(center.bg_backlog))

    # --- future arrivals: Poisson bursts ----------------------------------
    gaps = prng.exponential(k_arr_g, (cfg.n_arrivals,)) \
        / col(center.bg_arrival_rate)
    group_t = xla_f32.cumsum(gaps, dim=1)
    u = prng.uniform(k_arr_b, (cfg.n_arrivals,), 1e-6, 1.0 - 1e-6)
    p_burst = 1.0 / torch.maximum(center.bg_burst_mean, one)
    burst = torch.where(
        col(center.bg_burst_mean <= 1.0), one,
        torch.floor(xla_f32.log(u) / col(xla_f32.log1p(-p_burst))) + 1.0)
    slots = torch.arange(cfg.n_arrivals, dtype=torch.float32, device=dev)
    group_of = torch.searchsorted(torch.cumsum(burst, dim=1).contiguous(),
                                  slots.expand(b, -1).contiguous(),
                                  right=True)
    a_submit = torch.gather(group_t, 1, group_of.clamp(0, cfg.n_arrivals - 1))
    ac = widths(k_arr_c, cfg.n_arrivals)
    ad = durations(k_arr_d, cfg.n_arrivals)
    a_ok = a_submit <= cfg.horizon

    # --- workflow rows (policy is data: all variants, selected) -----------
    wf_off = cfg.n_warm + cfg.n_backlog + cfg.n_arrivals
    nst = cfg.max_stages
    y = torch.arange(nst, device=dev).unsqueeze(0)
    peak = wf_cores.amax(dim=1)
    total_dur = torch.where(wf_valid, wf_durs, 0.0).sum(dim=1)
    n_stages = wf_valid.to(torch.float32).sum(dim=1)
    useful_cs = torch.where(wf_valid, wf_cores * wf_durs, 0.0).sum(dim=1)
    is_pilot = policy == PILOT
    single = col((policy == BIGJOB) | is_pilot)
    pilot_dur = xla_f32.fma(n_stages, PILOT_TASK_LATENCY_S,
                            total_dur + PILOT_STARTUP_S)
    single_dur = torch.where(is_pilot, pilot_dur, total_dur)
    no_dep = col((policy == ASA_NAIVE) | (policy == RL))
    f_valid = torch.where(single, y == 0, wf_valid)
    f_cores = torch.where(single, torch.where(y == 0, col(peak), 0.0),
                          wf_cores)
    f_durs = torch.where(single, torch.where(y == 0, col(single_dur), 0.0),
                         wf_durs)
    f_submit = torch.where(y == 0, cfg.t0, _INF).to(torch.float32) \
        .expand(b, nst)
    nxt_valid = torch.cat([f_valid[:, 1:], f_valid.new_zeros(b, 1)], dim=1)
    f_next = torch.where(f_valid & nxt_valid & ~single, wf_off + y + 1, -1)
    f_dep = torch.where(f_valid & (y > 0) & ~single & ~no_dep,
                        wf_off + y - 1, -1)
    f_rows = torch.where(f_valid, wf_off + y, -1)
    waste_cs = torch.where(is_pilot,
                           xla_f32.fma(peak, pilot_dur, -useful_cs), 0.0)

    # --- assemble the table -------------------------------------------------
    nwm, nbk, nar = cfg.n_warm, cfg.n_backlog, cfg.n_arrivals
    f32, i32 = torch.float32, torch.int32

    def full(n: int, v, dtype=f32) -> torch.Tensor:
        return torch.full((b, n), v, dtype=dtype, device=dev)

    def cat(*parts: torch.Tensor, dtype=f32) -> torch.Tensor:
        return torch.cat([p.to(dtype) for p in parts], dim=1)

    submit = cat(full(nwm, 0.0), full(nbk, 0.0),
                 torch.where(a_ok, a_submit, _INF), f_submit)
    cores = cat(wc, torch.where(b_ok, bc, 0.0), torch.where(a_ok, ac, 0.0),
                f_cores)
    duration = cat(wd, bd, ad, f_durs)
    start = cat(torch.where(w_ok, 0.0, _INF), full(nbk, _INF),
                full(nar, _INF), full(nst, _INF))
    end = cat(torch.where(w_ok, w_end, _INF), full(nbk, _INF),
              full(nar, _INF), full(nst, _INF))
    status = cat(torch.where(w_ok, RUNNING, INVALID),
                 torch.where(b_ok, QUEUED, INVALID),
                 torch.where(a_ok, PENDING, INVALID),
                 torch.where(f_valid, PENDING, INVALID), dtype=i32)
    start_dep = cat(full(nwm + nbk + nar, -1, i32), f_dep, dtype=i32)
    wf_next = cat(full(nwm + nbk + nar, -1, i32), f_next, dtype=i32)
    is_wf = cat(full(nwm + nbk + nar, False, torch.bool), f_valid,
                dtype=torch.bool)

    def scalar(v, dtype=f32) -> torch.Tensor:
        return torch.full((b,), v, dtype=dtype, device=dev)

    return ScenarioState(
        submit=submit, cores=cores, duration=duration, start=start, end=end,
        status=status, start_dep=start_dep, wf_next=wf_next, is_wf=is_wf,
        pred_wait=full(cfg.max_jobs, 0.0),
        expected_end=full(cfg.max_jobs, -_INF),
        wf_rows=f_rows.to(i32),
        hold=full(nst, 0.0),
        canc_start=full(nst, _INF),
        start_pending=full(nst, False, torch.bool),
        chain_pending=full(nst, False, torch.bool),
        rl_obs=torch.zeros((b, nst, RL_FEATURES), dtype=f32, device=dev),
        rl_act=full(nst, -1, i32),
        est=est,
        t=scalar(0.0), free=free, total=total.clone(),
        policy=policy.to(i32), t0=scalar(cfg.t0),
        busy_cs=scalar(0.0), min_free=free.clone(),
        oh_cs=scalar(0.0), misses=scalar(0, i32),
        repass=scalar(False, torch.bool),
        pred_greedy=scalar(cfg.pred_mode == "greedy", torch.bool),
        steps=scalar(0, i32),
        fault_t=fault_t.to(f32), fault_c=fault_c.to(f32),
        fault_k=fault_k.to(i32),
        fault_next=scalar(0, i32), cap_debt=scalar(0.0),
        restarts=scalar(0, i32), restart_cs=scalar(0.0),
        pilot_waste_cs=waste_cs.to(f32),
        trace=(obs_trace.init(cfg.trace_capacity, b, device=dev)
               if cfg.trace_capacity else None),
    )


def build_scenario(key: torch.Tensor, center: XCenter, wf_cores, wf_durs,
                   wf_valid, est: asa.ASAState, policy, fault_t, fault_c,
                   fault_k, cfg: XSimConfig) -> ScenarioState:
    """One scenario (unbatched inputs) as a batch of one."""
    def one(x):
        return torch.as_tensor(x, device=key.device).unsqueeze(0)
    return build_batch(
        key.unsqueeze(0), XCenter(*(one(v) for v in center)), one(wf_cores),
        one(wf_durs), one(wf_valid),
        asa.ASAState(*(one(v) for v in est)), one(policy), one(fault_t),
        one(fault_c), one(fault_k), cfg)


@dataclass
class ScenarioGrid:
    """A flat batch of scenarios and the cell labels that produced them."""

    cfg: XSimConfig
    keys: torch.Tensor            # (B, 2) PRNG keys
    centers: XCenter              # stacked (B,)
    wf_cores: torch.Tensor        # (B, S)
    wf_durs: torch.Tensor         # (B, S)
    wf_valid: torch.Tensor        # (B, S)
    policies: torch.Tensor        # (B,) i32
    fault_t: torch.Tensor         # (B, n_faults)
    fault_c: torch.Tensor         # (B, n_faults)
    fault_k: torch.Tensor         # (B, n_faults)
    geo_idx: np.ndarray           # (B,) geometry id (center, scale) per row
    labels: list[dict]            # per-scenario {center, scale, workflow, …}

    @property
    def n(self) -> int:
        return int(self.policies.shape[0])

    @property
    def has_faults(self) -> bool:
        return int(self.fault_t.shape[1]) > 0

    def build(self, ests: asa.ASAState) -> ScenarioState:
        """``ests`` is a (B,)-batched ASAState (per-scenario estimators)."""
        return build_batch(self.keys, self.centers, self.wf_cores,
                           self.wf_durs, self.wf_valid, ests, self.policies,
                           self.fault_t, self.fault_c, self.fault_k,
                           self.cfg)


def make_grid(cfg: XSimConfig,
              center_names: Sequence[str] = ("hpc2n", "uppmax"),
              workflows: Sequence[str | Workflow] =
              ("montage", "blast", "statistics"),
              policy_ids: Sequence[int] = (0, 1, 2),
              n_seeds: int = 4, shrink: float = 1.0 / 64.0,
              scales: Sequence[int] | None = None,
              seed: int = 0, fault_sched=None, *,
              device: str | torch.device = DEFAULT_DEVICE) -> ScenarioGrid:
    """The full scenario product, flattened to one batch on ``device``.

    Cells = centers × their paper scales × workflows × policies × seeds.
    ``shrink`` miniaturises the centers (default 1/64: HPC2N → 263 cores);
    workflow scales shrink alongside. Background draws depend only on
    (geometry, seed), so the strategies and workflows of one cell see the
    identical machine.

    ``fault_sched`` injects capacity faults (``cfg.n_faults`` must cover
    the longest schedule): a ``runtime.fault.FaultSchedule`` applied to
    every scenario, or a callable ``label_dict -> FaultSchedule`` for
    per-scenario schedules (``xsim.families`` builds the standard
    robustness families). Event fractions are of the center's shrunk
    total cores, converted to whole cores here."""
    dev = resolve_device(device)
    if fault_sched is not None and cfg.n_faults == 0:
        raise ValueError("fault_sched given but cfg.n_faults == 0; set "
                         "XSimConfig(n_faults=...) to size the fault slots")
    cells, labels, geo, seeds_of, faults = [], [], [], [], []
    geo_ids: dict[tuple[str, int], int] = {}
    for cname in center_names:
        profile = CENTERS[cname]
        total_cores = _center_values(profile, shrink)[0]
        for scale in (scales or profile.scales):
            eff_scale = max(int(round(scale * shrink)), 2)
            gid = geo_ids.setdefault((cname, scale), len(geo_ids))
            for w in workflows:
                wf = w if isinstance(w, Workflow) else WORKFLOWS[w]
                sc, sd, sv = policies.stage_arrays(
                    wf, eff_scale, cfg.max_stages)
                for pol in policy_ids:
                    for s in range(n_seeds):
                        cells.append((profile, sc, sd, sv, pol))
                        geo.append(gid)
                        seeds_of.append(gid * 100_003 + s)
                        lab = dict(center=cname, scale=scale,
                                   workflow=wf.name,
                                   strategy=POLICY_NAMES[pol], seed=s)
                        labels.append(lab)
                        sched = (fault_sched(lab) if callable(fault_sched)
                                 else fault_sched) or FaultSchedule()
                        faults.append(sched.as_arrays(cfg.n_faults,
                                                      total_cores))
    b = len(cells)
    if b == 0:
        raise ValueError(
            "empty scenario grid: the centers × scales × workflows × "
            "policies × seeds product has no cells "
            f"(centers={list(center_names)!r}, workflows={list(workflows)!r},"
            f" policy_ids={list(policy_ids)!r}, n_seeds={n_seeds})")
    base = prng.PRNGKey(seed, dev)
    keys = prng.fold_in(base.expand(b, 2),
                        torch.tensor(seeds_of, dtype=torch.int64, device=dev))
    vals = np.array([_center_values(c[0], shrink) for c in cells],
                    dtype=np.float32)

    def stack(i: int, dtype) -> torch.Tensor:
        return torch.as_tensor(np.stack([c[i] for c in cells]), dtype=dtype,
                               device=dev)

    def fault_field(j: int, dtype) -> torch.Tensor:
        return torch.as_tensor(np.stack([f[j] for f in faults]), dtype=dtype,
                               device=dev)

    return ScenarioGrid(
        cfg=cfg,
        keys=keys,
        centers=XCenter(*(torch.as_tensor(vals[:, j], device=dev)
                          for j in range(vals.shape[1]))),
        wf_cores=stack(1, torch.float32),
        wf_durs=stack(2, torch.float32),
        wf_valid=stack(3, torch.bool),
        policies=torch.tensor([c[4] for c in cells], dtype=torch.int32,
                              device=dev),
        fault_t=fault_field(0, torch.float32),
        fault_c=fault_field(1, torch.float32),
        fault_k=fault_field(2, torch.int32),
        geo_idx=np.asarray(geo),
        labels=labels,
    )


def run_grid(grid: ScenarioGrid, fleet: asa.ASAState | None = None, *,
             pred_seed: int = 1, bf_passes: int = backfill.BF_PASSES,
             freed_mode: str = "auto", params=None, rl_mode: str = "sample",
             n_shards: int | None = None, mesh=None,
             device: str | torch.device = DEFAULT_DEVICE
             ) -> tuple[ScenarioState, dict[str, torch.Tensor]]:
    """Build and sweep the whole grid as one batch on ``device``.

    ``fleet`` is a batched ASAState (one estimator per geometry); None
    starts cold estimators. Every scenario carries its geometry's live
    estimator through the sweep; ``pred_seed`` decorrelates the
    per-scenario PRNG streams across sweeps. ``freed_mode`` selects the
    reservation-scan backend (``backfill.FREED_MODES``; the default runs
    the ``freed_scan`` kernel on CUDA). ``params`` is the learned
    submission policy's weights (``repro_torch.rl.policy.PolicyParams``),
    required when the grid holds policy id 4 scenarios; ``rl_mode`` picks
    sampled (training) or greedy (evaluation) actions for them. The
    program is picked from the grid, statically: the naive
    cancel/resubmit world when any scenario runs ASA-Naive or the learned
    policy, the fault machinery when the grid has fault slots.

    ``n_shards``/``mesh`` select the sharded path: the scenario axis is
    split over the blocks of a ``scenarios`` mesh
    (``events.sharded_sweep``; ``mesh`` wins when both are given,
    ``n_shards`` builds one over the first N devices of ``device``'s type
    with ``launch.mesh.make_scenarios_mesh``; under a ``torch.distributed``
    group, the ranks' mesh, one block a rank, every rank returning the
    whole result). The result is bitwise the single-device sweep's, and
    the metrics are computed on the gathered states, so they are too.
    Returns (final_states, metrics dict of (B,) tensors)."""
    dev = resolve_device(device)
    check_device(grid.keys, dev, "the grid")
    pols = grid.policies.cpu().numpy()
    if params is None and bool(np.any(pols == RL)):
        raise ValueError(
            "grid contains learned-policy (rl, id 4) scenarios; pass "
            "params= (repro_torch.rl.policy.PolicyParams) to run_grid")
    events.check_rl_mode(rl_mode)
    if mesh is None and n_shards is not None:
        mesh = make_scenarios_mesh(n_shards, device=dev)
    if fleet is None:
        fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    ests = policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), pred_seed)
    states = grid.build(ests)
    kw = dict(n_steps=grid.cfg.n_steps, chunk_steps=grid.cfg.chunk_steps,
              bf_passes=bf_passes, freed_mode=freed_mode,
              pred_mode=grid.cfg.pred_mode,
              naive=bool(np.any(np.isin(pols, (ASA_NAIVE, RL)))),
              params=params, rl_mode=rl_mode, faults=grid.has_faults)
    if mesh is None:
        final = events.sweep(states, device=dev, **kw)
    else:
        final = events.sharded_sweep(states, mesh=mesh, **kw)
    return final, compare.batched_metrics(final)


def stage_waits(final: ScenarioState, cfg: XSimConfig
                ) -> tuple[np.ndarray, np.ndarray]:
    """(waits, valid) of shape (B, max_stages) from a batched final state."""
    sl = slice(cfg.max_jobs - cfg.max_stages, cfg.max_jobs)
    waits = (final.start[:, sl] - final.submit[:, sl]).cpu().numpy()
    valid = final.is_wf[:, sl].cpu().numpy() & np.isfinite(waits)
    return waits, valid


def warm_fleet(fleet: asa.ASAState, grid: ScenarioGrid, rounds: int = 2,
               k: int = 8, seed: int = 100, params=None,
               n_shards: int | None = None, mesh=None, *,
               device: str | torch.device = DEFAULT_DEVICE) -> asa.ASAState:
    """§4.3 cross-run persistence: sweep, observe first-stage waits (a
    clean per-geometry queue sample), update every geometry's estimator,
    repeat. Returns the warmed fleet. ``params`` is forwarded to
    ``run_grid`` (required only when the grid holds learned-policy
    scenarios); ``n_shards``/``mesh`` likewise select its sharded
    sweep."""
    dev = resolve_device(device)
    if mesh is None and n_shards is not None:
        mesh = make_scenarios_mesh(n_shards, device=dev)
    n_geo = fleet.log_p.shape[0]
    # BigJob's and the pilot's row 0 is the peak-cores monolith, not a
    # stage-shaped job: each geometry learns from clean stage-0 samples
    stagelike = np.array([lab["strategy"] not in ("bigjob", "pilot")
                          for lab in grid.labels])
    for r in range(rounds):
        final, _ = run_grid(grid, fleet, pred_seed=seed + r, params=params,
                            mesh=mesh, device=dev)
        waits, valid = stage_waits(final, grid.cfg)
        w = np.zeros((n_geo, k), np.float32)
        v = np.zeros((n_geo, k), bool)
        for g in range(n_geo):
            sel = (grid.geo_idx == g) & stagelike
            wg = waits[sel, 0]
            wg = wg[valid[sel, 0]][:k]
            w[g, :len(wg)] = wg
            v[g, :len(wg)] = True
        fleet = policies.update_fleet(fleet, torch.as_tensor(w, device=dev),
                                      torch.as_tensor(v, device=dev))
    return fleet
