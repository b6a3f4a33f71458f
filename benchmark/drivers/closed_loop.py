"""The closed-loop sweep: many lanes of one batched simulator, each with its
own (mu, cs), driven by a learned Frenet planner.

A control step is ``TrackEnv.observe`` -> ``IRBFNFrenetPlanner.plan_batch``
-> ``TrackEnv.step``, as ``TrackEnv.rollout`` runs it, and ends in one
synchronisation: a controller needs its action before the next step. Every
``episode_steps`` steps the lanes start again from the raceline with fresh
pose noise, inside the window. The noise comes as ``eval_closed_loop``
draws it: ``key, sub = split(key)`` an episode from the seed's key, and
``TrackEnv.reset(key=sub)``; the set-up's start takes the chain's first
key, so the key chain's first draw counts as set-up.

``correct``: the reference recomputes, from the program's own states at
steps drawn by the seed, the observation, the planner's first controls and
the next state, and each episode's start from the seed's key chain
(``judge``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, traffic
from benchmark.drivers import _common
from benchmark.harness import ROOT, Outcome
from benchmark.reference import keys
from benchmark.reference import precision as prec
from benchmark.reference import track as rtrack
from benchmark.reference import vehicle, wcrbf
from benchmark.trace import Spans, profile, summarize


class Program:
    """The system under test, built from the configuration and the traffic:
    the env, the planner and the policy, on ``device``."""

    def __init__(self, cell, device):
        from irbfn_tpu_torch.planning import IRBFNFrenetPlanner
        from irbfn_tpu_torch.sim.env import TrackEnv
        from irbfn_tpu_torch.sim.eval_closed_loop import sweep_params
        from irbfn_tpu_torch.sim.track import oval_track
        from irbfn_tpu_torch.train import (input_bounds_from_config,
                                           load_model)
        from irbfn_tpu_torch.utils import prng

        t, c = cell.traffic, cell.config
        mu, cs = traffic.sweep_lanes(t)
        self.lanes = mu.size
        tk = t["track"]
        self.track = oval_track(tk["length"], tk["width"],
                                n_samples=tk["samples"], speed=tk["speed"],
                                device=device)
        # the sweep's per-lane cars, as eval_closed_loop builds them
        combos = np.stack([mu[::t["trials"]], cs[::t["trials"]]], axis=-1)
        params = sweep_params(combos, int(t["trials"]), device)
        self.env = TrackEnv(self.track, params, sim_dt=t["sim_dt"],
                            control_dt=t["control_dt"],
                            half_width=t["half_width"], control_mode="accl")
        model, conf = load_model(str(ROOT / c["net_config"]),
                                 str(ROOT / c["weights"]), device=device)
        self.planner = IRBFNFrenetPlanner(
            model.eval(), self.track, horizon=c["planner"]["horizon"],
            input_bounds=input_bounds_from_config(conf))
        self.key = prng.PRNGKey(cell.seed, device=device)
        self._split = prng.split

    def reset(self, t):
        """The next episode's start: ``key, sub = split(key)``, then the
        env's reset from ``sub``, as ``eval_closed_loop`` starts a trial."""
        self.key, sub = self._split(self.key)
        return self.env.reset(s0=0.0, speed0=t["speed0"], key=sub,
                              noise_scale=t["noise_scale"],
                              batch_shape=(self.lanes,))

    def observe(self, sim):
        return self.env.observe(sim)

    def plan(self, obs):
        res = self.planner.plan_batch(obs.s, obs.ey, obs.epsi, obs.delta,
                                      obs.linear_vel_x, obs.linear_vel_y,
                                      obs.ang_vel_z)
        return torch.stack([res.accel, res.steer_vel], dim=-1)

    def step(self, sim, action):
        return self.env.step(sim, action)


def run(cell) -> Outcome:
    t, c = cell.traffic, cell.config
    device = torch.device(cell.device)
    prec.no_tf32()
    _common.reset_peak(device)
    prog = Program(cell, device)
    B = prog.lanes

    # set-up: the kernel's build, the key chain's first draw and every shape
    # of a step, from the chain's first start, which the window does not use
    sim = prog.reset(t)
    for _ in range(int(t["warmup_steps"])):
        sim = prog.step(sim, prog.plan(prog.observe(sim)))
    _common.sync(device)

    spans = Spans(cell.trace, device)
    rec = dict(x=[], done=[], action=[], next=[], resets=[])
    step_s = []
    episode = int(t["episode_steps"])
    t0 = time.perf_counter()
    setup_s = time.time() - cell.t_start
    k = 0
    while True:
        ts = time.perf_counter()
        if k % episode == 0:
            sim = prog.reset(t)
            rec["resets"].append(sim.x)
        with spans.span("bench.observe"):
            obs = prog.observe(sim)
        with spans.span("bench.plan"):
            action = prog.plan(obs)
        with spans.span("bench.env_step"):
            nxt = prog.step(sim, action)
        _common.sync(device)
        te = time.perf_counter()
        step_s.append(te - ts)
        rec["x"].append(sim.x)
        rec["done"].append(sim.done)
        rec["action"].append(action)
        rec["next"].append(nxt.x)
        sim = nxt
        k += 1
        if te - t0 >= cell.seconds:
            break
    window = time.perf_counter() - t0
    steps = k

    layer = {}
    summary = None
    if cell.trace:
        n_prof = int(t["profile_steps"])
        with profile(device) as p:
            tp = _common.now(device)
            for _ in range(n_prof):
                with torch.profiler.record_function("bench.observe"):
                    obs = prog.observe(sim)
                with torch.profiler.record_function("bench.plan"):
                    action = prog.plan(obs)
                with torch.profiler.record_function("bench.env_step"):
                    sim = prog.step(sim, action)
            wall = _common.now(device) - tp
        summary = summarize(p, wall, n_prof)
        net = c
        flops = counts.control_step_flops(
            B, net["num_regions"], net["num_kernels"], net["in_features"],
            net["out_features"], t["track"]["samples"],
            substeps=int(round(t["control_dt"] / t["sim_dt"])),
            horizon=net["planner"]["horizon"])
        rbf = (counts.rbf_forward_ops(B, net["num_regions"],
                                      net["num_kernels"], net["in_features"],
                                      net["out_features"]),
               counts.rbf_forward_bytes(B, net["num_regions"],
                                        net["num_kernels"],
                                        net["in_features"],
                                        net["out_features"]))
        layer = dict(spans=dict(spans.times), trace=summary,
                     step_flops=flops, rbf_ops_bytes=rbf,
                     window_s=window, steps=steps)
    peak = _common.memory_peak(device)

    records = _freeze(rec)
    del prog, sim, nxt, obs, action, rec
    _common.release(device)
    checks = judge(cell, records, "program", device)
    if cell.control:
        layer["control"] = judge(cell, records, "control", device)
    p95 = float(np.percentile(np.asarray(step_s), 95))
    return Outcome(
        attempted=B * steps, failed=checks.pop("failed"),
        end_to_end=dict(lane_steps_per_s=B * steps / window,
                        step_p95_ms=1e3 * p95, setup_s=setup_s),
        layer=layer, checks=checks, memory_peak_bytes=peak, trace=summary,
        device_kind=_common.device_kind(device), device_count=1)


def _freeze(rec) -> dict:
    """The window's record as stacked tensors (n, B, ...): the state each
    step started from, its done flags, its controls and the state it
    produced; and the episodes' starts."""
    return dict(x=torch.stack(rec["x"]), done=torch.stack(rec["done"]),
                action=torch.stack(rec["action"]),
                next=torch.stack(rec["next"]), resets=rec["resets"])


# ------------------------------------------------------------------ check

class _Ref:
    """A plain reference: line, net and per-lane cars, the net in
    ``net_precision`` and the simulator (start and step) in
    ``sim_precision``."""

    def __init__(self, cell, net_precision, sim_precision, device):
        t, c = cell.traffic, cell.config
        tk = t["track"]
        self.dtype = prec.dtype_of(net_precision)
        self.sim_dtype = prec.dtype_of(sim_precision)

        def line(dtype):
            return rtrack.oval_line(tk["length"], tk["width"], tk["samples"],
                                    tk["speed"], dtype, device)

        self.line = line(self.dtype)
        self.sim_line = line(self.sim_dtype)
        self.net = wcrbf.load_net(str(ROOT / c["net_config"]),
                                  str(ROOT / c["weights"]), net_precision,
                                  device)
        mu, cs = traffic.sweep_lanes(t)
        self.mu = torch.as_tensor(mu, dtype=self.sim_dtype, device=device)
        self.cs = torch.as_tensor(cs, dtype=self.sim_dtype, device=device)
        self.horizon_time = c["planner"]["horizon"] * c["planner"]["plan_dt"]
        self.t = t

    def car(self, reps: int):
        return vehicle.Car(self.mu.repeat(reps), self.cs.repeat(reps))

    def start(self, noise):
        """A start from unit-normal pose noise (lanes, 3), float64."""
        t, dtype = self.t, self.sim_dtype
        n = noise.to(dtype) * t["noise_scale"]
        zero = torch.zeros(noise.shape[0], dtype=dtype, device=noise.device)
        x, y, th = rtrack.frenet_to_cartesian(self.sim_line, zero, zero)
        return torch.stack([x + n[:, 0], y + n[:, 1], zero,
                            torch.full_like(zero, t["speed0"]),
                            th + n[:, 2], zero, zero], dim=-1)

    def action(self, x, proj, flip=None):
        delta, vx = x[:, 2], x[:, 3]
        vy, wz = x[:, 3] * torch.tan(x[:, 6]), x[:, 5]
        curv = rtrack.interp_wrapped(self.line, self.line.ks, proj.s)
        vxg = rtrack.interp_wrapped(self.line, self.line.vxs,
                                    proj.s + vx * self.horizon_time)
        return wcrbf.frenet_action(self.net, proj.ey, delta, vx, vy, vxg, wz,
                                   proj.epsi, curv, flip)

    def next_state(self, x, a, done, reps, v_blend=vehicle.V_BLEND):
        t = self.t
        x, a = x.to(self.sim_dtype), a.to(self.sim_dtype)
        sub = int(round(t["control_dt"] / t["sim_dt"]))
        xn = vehicle.control_period(x, a, self.car(reps), sub, t["sim_dt"],
                                    v_blend)
        return torch.where(done[:, None], x, xn)


# the simulator's model switch, moved a hair either side (vehicle.py)
BLEND_TIES = (0.0, -1e-5, 1e-5)


def _action_gap(ref, x, a_judged):
    """Per lane, the least gap between the judged controls and the
    reference's over the observations a tie admits."""
    first, second, tied = rtrack.project(ref.line, x[:, 0], x[:, 1],
                                         x[:, 4])
    inf = torch.full(x.shape[:1], float("inf"), dtype=x.dtype,
                     device=x.device)
    best = inf
    for proj, valid in ((first, torch.ones_like(tied)), (second, tied)):
        near = (proj.ey - wcrbf.MIRROR_EY).abs() < 1e-5
        for flip, ok in ((None, valid), (near, valid & near)):
            if not bool(ok.any()):
                continue
            gap = (ref.action(x, proj, flip) - a_judged).abs().amax(-1)
            best = torch.minimum(best, torch.where(ok, gap, inf))
    return best


def judge(cell, rec, judged: str, device, block: int = 16384) -> dict:
    """The numbers that decide ``correct``, for the program's outputs
    (``judged="program"``) or for the control's (``"control"``: the
    reference in the program's place, from the same states, its net's head
    product in TF32 and its simulator in bfloat16):
    ``start_gap`` (m, rad), ``action_gap`` (m/s^2, rad/s) and ``state_gap``
    (relative to 1 + |x|), each the largest over what was compared, and
    ``failed``, live lanes whose controls were not finite."""
    ref = _Ref(cell, "f64", "f64", device)
    ctl = (_Ref(cell, "tf32", "bf16", device) if judged == "control"
           else None)
    t = cell.traffic
    start_gap = 0.0
    B = rec["x"].shape[1]
    # the window's episodes took the chain's keys after the set-up's first
    subs = keys.episode_keys(cell.seed, 1 + len(rec["resets"]))[1:]
    for sub, x0 in zip(subs, rec["resets"]):
        noise = torch.as_tensor(keys.normal(sub, (B, 3)), device=device)
        want = ref.start(noise)
        got = (ctl.start(noise) if ctl else x0).to(torch.float64)
        start_gap = max(start_gap, float((got - want).abs().max()))

    n = rec["action"].shape[0]
    steps = _common.sample(n, int(t["check_steps"]),
                           traffic.rng(cell.seed, traffic.CHECK_SAMPLE))
    x_all = rec["x"][steps].reshape(-1, 7)
    nxt_all = rec["next"][steps].reshape(-1, 7)
    a_all = rec["action"][steps].reshape(-1, 2)
    done_all = rec["done"][steps].reshape(-1)
    action_gap, state_gap, failed = 0.0, 0.0, 0
    per = max(1, block // B) * B
    for i in range(0, x_all.shape[0], per):
        x32, a32 = x_all[i:i + per], a_all[i:i + per]
        done, reps = done_all[i:i + per], x32.shape[0] // B
        live = torch.isfinite(x32).all(-1)
        failed += int((live & ~done & ~torch.isfinite(a32).all(-1)).sum())
        x = x32.to(torch.float64)
        if ctl is not None:
            xc = x32.to(torch.float32)
            first, _, _ = rtrack.project(ctl.line, xc[:, 0], xc[:, 1],
                                         xc[:, 4])
            a_j = ctl.action(xc, first)
            nxt_j = ctl.next_state(xc, a_j, done, reps)
        else:
            a_j, nxt_j = a32, nxt_all[i:i + per]
        a_j, nxt_j = a_j.to(torch.float64), nxt_j.to(torch.float64)
        gap = _action_gap(ref, x, a_j)
        action_gap = max(action_gap, _worst(gap, live))
        rel = None
        for tie in BLEND_TIES:
            want = ref.next_state(x, a_j, done, reps, vehicle.V_BLEND + tie)
            r = ((nxt_j - want).abs() / (1.0 + want.abs())).amax(-1)
            r = torch.where(torch.isnan(r), torch.full_like(r, float("inf")),
                            r)
            rel = r if rel is None else torch.minimum(rel, r)
        state_gap = max(state_gap, _worst(rel, live & torch.isfinite(
            want).all(-1)))
    return dict(start_gap=start_gap, action_gap=action_gap,
                state_gap=state_gap, failed=failed)


def _worst(gap, mask) -> float:
    """The largest gap over ``mask``; a gap that is not a number counts as
    infinite."""
    g = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")),
                    gap)[mask]
    return float(g.max()) if g.numel() else 0.0
