"""Runner of the training cells: decentralized training through the port's
simulation engine (``repro_torch.sim.engine.simulate_decentralized``), n
nodes on one card, one call from the seed to the window's end.

Set-up draws the weights, builds the method and the schedule, and starts
the one call; its first ``warm_steps`` steps are set-up, and the last two
of them give the step's time, from which the window's count of steps is
set: as many whole steps as fill ``--seconds``.  The feed of step
``warm_steps`` synchronises and starts the clock, and the feed of the
first step past the window synchronises, stops the clock and ends the
call.  So the steps the reference follows are the window's own call,
state and feed.

``correct`` compares the program with the float32 reference
(``reference/<config>.py``, which stores what the configuration stores
in its type), run after the window, twice:

- the start: the first three steps from the seed's weights: the first
  step's loss on every node, each leaf's gradient norm as the optimizer
  took it (its momentum after one step), its momentum after the three,
  and its change after the three;
- the window's last step, from the parameters and momentum the timed
  steps left (the program's own state, held as the step began): each
  leaf's gradient norm as the optimizer got it, its momentum after the
  step, and its change in the step.

The reference cannot replay the whole window within the run's time, so
the window's step starts from the program's state; the start checks the
state the first steps build by themselves (:func:`numbers`).
"""
from __future__ import annotations

import dataclasses
import gc
import math

import torch

from perfbench import arith, lib


class _WindowDone(Exception):
    pass


def _norms(tree: dict, nodes: int) -> dict:
    """Per leaf, the (nodes,) float32 norms of a node-stacked dict."""
    return {k: torch.linalg.vector_norm(x.float().reshape(nodes, -1), dim=1)
            for k, x in tree.items()}


def _change(after: dict, before: dict, nodes: int) -> dict:
    """Per leaf, the (nodes,) float32 norms of ``after - before``."""
    return {k: torch.linalg.vector_norm(
        (x.float() - before[k].float()).reshape(nodes, -1), dim=1)
        for k, x in after.items()}


def _cpu(tree: dict) -> dict:
    return {k: v.cpu() for k, v in tree.items()}


def _worst(prog: dict, ref: dict, keys=None) -> float:
    """The widest gap between the program's and the reference's norm of a
    leaf, node by node, against the reference's norm of that leaf or of
    the node's median leaf, whichever is larger (``keys``: the leaves
    judged, every leaf by default).  A gap over a norm of nought is
    infinite: the program moved what the reference left."""
    keys = list(ref) if keys is None else list(keys)
    if not keys:
        return float("nan")
    med = torch.stack([ref[k] for k in ref]).median(dim=0).values
    worst = 0.0
    for k in keys:
        den = torch.maximum(ref[k], med)
        diff = (prog[k].to(den) - ref[k]).abs()
        gap = torch.where(diff == 0, 0.0, diff / den)
        worst = max(worst, float(gap.max()))
    return worst


def _live(gnorm: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's, on every node.  (A leaf
    under softmax or a norm whose gradient is nought moves by round-off
    alone.)"""
    med = torch.stack(list(gnorm.values())).median(dim=0).values
    return [k for k, v in gnorm.items() if bool((v >= 1e-3 * med).all())]


def run(*, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str = "cuda", fault: str | None = None,
        per_layer=(), t_start: float | None = None,
        controls: bool = False, witness: bool = False) -> dict:
    """One run of a training cell.  ``fault`` plants a fault under the
    timed path (``unchanged``, ``half_batch``, ``no_mix``); ``witness``
    runs the program's other path, the mix as a callable, so that the
    update takes no self-weight; ``controls`` adds the control's
    numbers.  The benchmark's own runs use none of them."""
    from repro_torch import trace as marks_mod
    from repro_torch.models import model as M
    from repro_torch.optim.decentralized import make_method, mix
    from repro_torch.sim.engine import simulate_decentralized
    from repro_torch.topology import TopologySpec

    t_start = lib.now() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    pcfg = lib.port_config(config)
    n, warm = traffic["nodes"], traffic["warm_steps"]
    if warm < 2:
        raise ValueError("warm_steps must be 2 or more: the last warm "
                         "steps time the window")
    specs = M.param_specs(pcfg, torch.bfloat16)
    index = lib.leaf_index(specs)
    w0 = lib.draw_weights(specs, seed, torch.bfloat16, dev)
    gen = lib.load_module("traffic", "train.py").batches(config, traffic,
                                                         seed, dev)
    method = make_method(traffic["method"], momentum=traffic["momentum"])
    spec = TopologySpec(name=traffic["topology"]["name"], n=n,
                        k=traffic["topology"]["k"])

    got = {"losses": []}
    calls = [0]
    win: dict = {"last": None}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def loss_fn(p, b):
        if fault == "half_batch":
            half = b["tokens"].shape[0] // 2
            b = {k: v[:half] for k, v in b.items()}
        loss = M.loss_fn(pcfg, p, b)[0]
        if len(got["losses"]) < warm * n:
            got["losses"].append(loss.detach())
        return loss

    def step(params_n, grads, state, W, eta):
        t = calls[0]
        calls[0] += 1
        if fault == "no_mix":
            W = torch.eye(n, device=W.device, dtype=W.dtype)
        if witness:
            W = (lambda tree, W=W: mix(W, tree))
        if fault == "unchanged":
            new_p, new_s = params_n, state
        else:
            new_p, new_s = method.step(params_n, grads, state, W, eta)
        if t == 0:
            got["grad"] = _norms(new_s["u"], n)
        if t == warm - 1:
            got["mom"] = _norms(new_s["u"], n)
            with torch.no_grad():
                got["change"] = {
                    k: torch.linalg.vector_norm(
                        (x.float() - lib.draw_leaf(k, x.shape[1:], index[k],
                                                   seed, torch.bfloat16, dev)
                         .float()).reshape(n, -1), dim=1)
                    for k, x in new_p.items()}
        if t == win["last"]:
            # the step's inputs and outputs, held past it: the step had
            # them all alive at once, so holding them adds nothing to its
            # peak, and the window ends with this step
            got["win"] = {"t": t, "x": params_n, "u": state["u"],
                          "g": grads, "x1": new_p, "u1": new_s["u"]}
        return new_p, new_s

    timed = dataclasses.replace(method, step=step)
    # a traced run profiles ``traced_steps`` whole steps after the window's
    # first; the phase marks of the other steps give the per-layer spans
    tracer = lib.Trace() if trace else None
    marks_cm = marks_mod.cuda_marks() if trace else None
    t_on, t_off = warm + 1, warm + 1 + traffic["traced_steps"]

    def feed(t: int):
        if t == 0:
            w0.clear()          # the engine holds its node-stacked copy
        if t == warm - 2:
            sync()
            win["t_warm"] = lib.now()
        if trace and t in (t_on, t_off) and "t1" not in win:
            sync()
            if t == t_on:
                win["slice"] = [len(win["marks"]), None, lib.now(), None]
                tracer.__enter__()
            elif "slice" in win and win["slice"][1] is None:
                tracer.__exit__(None, None, None)
                win["slice"][1] = len(win["marks"])
                win["slice"][3] = lib.now()
        if t == warm:
            sync()
            if trace:
                win["marks"] = marks_cm.__enter__()
            win["t0"] = lib.now()
            win["setup_s"] = win["t0"] - t_start
            step_s = (win["t0"] - win["t_warm"]) / 2
            win["steps"] = max(round(seconds / step_s),
                               traffic["traced_steps"] + 2 if trace else 2)
            win["last"] = warm + win["steps"] - 1
        elif "steps" in win and t == warm + win["steps"]:
            sync()
            win["t1"] = lib.now()
            raise _WindowDone
        return gen(t)

    try:
        simulate_decentralized(
            loss_fn=loss_fn, params=w0, method=timed, schedule=spec,
            batches=feed, steps=warm + 100_000, eta=traffic["eta"],
            device=dev)
    except _WindowDone:
        pass
    finally:
        if trace and "marks" in win:
            marks_cm.__exit__(None, None, None)
    window = win["t1"] - win["t0"]
    steps = win["steps"]
    tokens = steps * n * traffic["seqs_per_node"] * traffic["seq_len"]
    out = {"attempted": steps, "failed": 0,
           "metrics": {"train_tokens_per_s": tokens / window,
                       "setup_s": win["setup_s"]},
           "window_s": window, "steps": steps}
    if cuda:
        torch.cuda.synchronize()
        out["device"] = lib.device_record()
    if trace:
        out.update(_per_layer(config, traffic, specs, win, tracer,
                              per_layer, steps, window))
    losses = torch.stack(got["losses"]).float().cpu().reshape(warm, n)
    wv = got.pop("win")
    with torch.no_grad():
        prog = {"start": (losses,) + tuple(_cpu(got[part]) for part in
                                            ("grad", "mom", "change")),
                "window": (_cpu(_norms(wv["g"], n)), _cpu(_norms(wv["u1"], n)),
                           _cpu(_change(wv["x1"], wv["x"], n)))}
    x_last, u_last, t_last = wv["x"], wv["u"], wv["t"]
    del got, wv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = lib.now()

    precisions = ("f32", "fp8") if controls else ("f32",)
    win_ref = {pr: window_readings(config, traffic, seed, dev, x_last, u_last,
                                   t_last, pr) for pr in precisions}
    del x_last, u_last
    gc.collect()
    ref = {pr: {"window": win_ref[pr],
                "start": start_readings(config, traffic, specs, index, seed,
                                        dev, pr)} for pr in precisions}
    got = numbers(prog, ref["f32"])
    out["checks"] = {k: [got[k], lim] for k, lim in traffic["limits"].items()}
    out["readings"] = got
    if controls:
        out["control"] = numbers(ref["fp8"], ref["f32"])
    out["reference_s"] = lib.now() - t_ref
    return out


def _batches(config, traffic, seed, dev):
    """Each step's batches as the reference takes them: a list of each
    node's batch dict."""
    gen = lib.load_module("traffic", "train.py").batches(config, traffic,
                                                         seed, dev)

    def batches(t):
        b = gen(t)
        return [{"tokens": torch.as_tensor(b["tokens"][i], device=dev),
                 "labels": torch.as_tensor(b["labels"][i], device=dev),
                 **({"frames": b["frames"][i]} if "frames" in b else {})}
                for i in range(traffic["nodes"])]
    return batches


def _reference(config):
    ref = lib.load_module("reference", f"{config['name']}.py")
    ref.P.strict()
    return ref


def start_readings(config, traffic, specs, index, seed, dev,
                   precision="f32"):
    """The reference's first ``warm_steps`` steps from the seed's weights
    and the same batches: (losses (steps, n), the first step's gradient
    norms, momentum norms after the steps, change norms), the norms per
    leaf and node."""
    ref = _reference(config)
    n, steps = traffic["nodes"], traffic["warm_steps"]
    x0 = {k: lib.draw_leaf(k, v.shape, index[k], seed, torch.bfloat16, dev)
          for k, v in specs.items()}
    got = {"losses": []}

    def on_step(t, losses, x, u, gnorm):
        got["losses"].append(losses)
        if t == 0:
            got["grad"] = gnorm
        if t == steps - 1:
            got["mom"] = _cpu(_norms(u, n))
            got["change"] = {k: torch.linalg.vector_norm(
                (v.float() - x0[k].float()).reshape(n, -1), dim=1).cpu()
                for k, v in x.items()}

    ref.dsgdm_steps(config, {k: v.expand(n, *v.shape) for k, v in x0.items()},
                    None, _batches(config, traffic, seed, dev), nodes=n,
                    k=traffic["topology"]["k"], momentum=traffic["momentum"],
                    eta=traffic["eta"], steps=steps,
                    pr=ref.P.Precision(precision), on_step=on_step)
    return (torch.tensor(got["losses"], dtype=torch.float32), got["grad"],
            got["mom"], got["change"])


def window_readings(config, traffic, seed, dev, x, u, t, precision="f32"):
    """The reference's step ``t`` from the node-stacked parameters ``x``
    and momentum ``u`` the program held as it began, on that step's
    batches: (gradient norms, momentum norms after it, change norms)."""
    ref = _reference(config)
    n = traffic["nodes"]
    got = {}

    def on_step(_, losses, x1, u1, gnorm):
        got["w"] = (gnorm, _cpu(_norms(u1, n)), _cpu(_change(x1, x, n)))

    ref.dsgdm_steps(config, x, u, _batches(config, traffic, seed, dev),
                    nodes=n, k=traffic["topology"]["k"],
                    momentum=traffic["momentum"], eta=traffic["eta"],
                    steps=1, t0=t, pr=ref.P.Precision(precision),
                    on_step=on_step)
    return got["w"]


def numbers(prog, ref) -> dict:
    """The numbers ``correct`` can compare, from the program's and the
    reference's readings (``start``: losses, gradient, momentum and change
    norms; ``window``: gradient, momentum and change norms): the widest
    relative gap of a node's loss at a step, and of a leaf's norm
    (:func:`_worst`).  A change is judged on the leaves whose reference
    gradient is not nought (:func:`_live`)."""
    (pl, pg, pm, pc), (rl, rg, rm, rc) = prog["start"], ref["start"]
    (wg, wm, wc), (vg, vm, vc) = prog["window"], ref["window"]
    live, live_w = _live(rg), _live(vg)
    return {"loss_gap": float(((pl - rl).abs() / rl.abs()).max()),
            "loss0_gap": float(((pl[0] - rl[0]).abs() / rl[0].abs()).max()),
            "grad_gap": _worst(pg, rg), "mom_gap": _worst(pm, rm),
            "change_gap": _worst(pc, rc, live),
            "win_grad_gap": _worst(wg, vg), "win_mom_gap": _worst(wm, vm),
            "win_change_gap": _worst(wc, vc, live_w),
            "live_leaves": len(live), "live_leaves_win": len(live_w)}


def _per_layer(config, traffic, specs, win, tracer, names, steps,
               window) -> dict:
    """Per-layer metrics: kernels and idle share from the profiled steps,
    spans and the step's share of the peak from the others."""
    dev_events, host = tracer.events()
    red = lib.reduce_trace(dev_events, host)
    i0, i1, s0, s1 = win["slice"]
    traced = traffic["traced_steps"]
    n, b, t = traffic["nodes"], traffic["seqs_per_node"], traffic["seq_len"]
    frames = traffic.get("frames", 0)
    H, KV, hd = config["num_heads"], config["num_kv_heads"], config["head_dim"]
    flash = []
    for _ in range(traced * n):
        flash += [arith.flash_work(batch=b, heads=H, kv_heads=KV, hd=hd,
                                   tq=frames, s=frames, causal=False)] \
            * config["encoder_layers"]
        flash += [arith.flash_work(batch=b, heads=H, kv_heads=KV, hd=hd,
                                   tq=t, s=t, causal=True),
                  arith.flash_work(batch=b, heads=H, kv_heads=KV, hd=hd,
                                   tq=t, s=frames, causal=False)] \
            * config["decoder_layers"]
    leaves = [(n * math.prod(v.shape), 2, 2, 2) for v in specs.values()]
    work = {"flash": flash,
            "fused_dsgd": [arith.fused_dsgd_work(leaves)] * traced}
    marks = win["marks"]
    ctx = {"marks": lib.mark_spans(marks[:i0]) + lib.mark_spans(marks[i1:]),
           "steps": steps - traced, "window_s": window - (s1 - s0),
           "slice_s": s1 - s0, "kernel_s": lib.kernel_seconds(dev_events),
           "busy_per_step_s": red["busy_s"] / traced,
           "wall_per_step_s": (window - (s1 - s0)) / (steps - traced),
           "work": work, "busy_s": red["busy_s"],
           "flops_per_step": arith.train_step_flops(
               config, nodes=n, batch=b, seq=t, frames=frames)}
    return {"per_layer": lib.read_metrics(names, ctx),
            "busy_s": red["busy_s"], "traced_s": s1 - s0,
            "breakdown": {"device_ops": red["device_ops"],
                          "idle_gaps": red["idle_gaps"]}}
