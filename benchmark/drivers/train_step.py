"""Driver of the training cells: the program's train step
(``training/step.py::make_train_step``, device projection) on a train state
made from the configuration's weights (``training/state.py``), fed in a
closed loop from a pool of distinct host batches.

Set-up builds the one state and step, and drives them through the first
``reference_steps`` steps on the pool's first batches, reading the losses,
the first gradient as Adam holds it and the change of every parameter and
statistic; the window then goes on with the same objects.  After the
window the reference repeats those steps from the same weights, batches
and seed.
"""

from __future__ import annotations

import gc
import json
import statistics
import time
from typing import Dict

from benchmark import compare, generate, harness, program
from benchmark.counts import network as counts
from benchmark.stretch import StageTimer, Stretch

KIND = "train"


def _leaves(state) -> Dict:
    named = dict(state.model.named_parameters())
    named.update(w_x=state.w_x, w_q=state.w_q)
    return named


def program_setup(cell, seed: int, device):
    """The program's state, step and generator after the first steps, the
    host batches, and what those steps read (losses, first gradient,
    change)."""
    import torch
    from efficientlo_net_torch.training.state import create_train_state
    from efficientlo_net_torch.training.step import make_train_step

    traffic, hp = cell.traffic, cell.traffic["hyperparameters"]
    cfg = program.model_config(cell.config)
    tcfg = program.train_config(traffic)
    t0 = time.perf_counter()
    batches = generate.train_batches(seed, cell.config["sensor"], traffic, device)
    t1 = time.perf_counter()
    state = create_train_state(program.load_model(cell.config, device), tcfg, device=device)
    t2 = time.perf_counter()
    opt = state.optimizer.defaults
    if tcfg.optimizer != "adam" or tuple(opt["betas"]) != (hp["adam_b1"], hp["adam_b2"]) \
            or opt["eps"] != hp["adam_eps"]:
        raise RuntimeError(f"the program's optimizer {tcfg.optimizer} {opt} is not the mix's")
    step = make_train_step(cfg, tcfg, host_projected=False)
    gen = torch.Generator(device).manual_seed(seed)
    leaves = _leaves(state)
    before = {n: p.detach().clone() for n, p in leaves.items()}
    before.update({n: b.clone() for n, b in state.model.named_buffers()})
    losses: Dict = {}
    first_grad = None
    for i in range(traffic["reference_steps"]):
        state, metrics = step(state, batches[i], gen)
        for k, v in metrics.items():
            losses.setdefault(k, []).append(float(v))
        if first_grad is None:
            first_grad = {n: (state.optimizer.state[p]["exp_avg"] / (1.0 - hp["adam_b1"])).cpu()
                          for n, p in leaves.items()}
    after = {n: p.detach() for n, p in leaves.items()}
    after.update(dict(state.model.named_buffers()))
    change = {n: (after[n] - before[n]).cpu() for n in before}
    readings = {"losses": losses, "first_grad": first_grad, "change": change}
    print(json.dumps({"setup_phases_s": {"inputs": t1 - t0, "model": t2 - t1,
                                         "first_steps": time.perf_counter() - t2}}))
    return state, step, gen, batches, readings


def reference_readings(cell, seed: int, batches, device, tf32: bool = False) -> Dict:
    """The reference's losses, first gradient and change over the first
    steps; ``tf32`` computes its matrix products in TF32 (the control)."""
    import torch
    from benchmark.reference import train as ref_train

    net = ref_train.network(cell.config, harness.ROOT / cell.config["weights"], device)
    with ref_train.matmul_tf32(tf32):
        out = ref_train.train_steps(net, batches[:cell.traffic["reference_steps"]],
                                    torch.Generator(device).manual_seed(seed),
                                    cell.traffic["hyperparameters"], cell.traffic["batch_size"],
                                    device)
    return {"losses": out["losses"],
            "first_grad": {n: g.cpu() for n, g in out["first_grad"].items()},
            "change": {n: c.cpu() for n, c in out["change"].items()}}


def checks(prog: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap: the largest gap of the first step's five losses; grad_gap:
    the worst leaf's gap of first-gradient norms; change_gap: the worst
    leaf's gap of the norms of its change over the steps (leaves that move
    by round-off alone left out, statistics kept).  The losses of the later
    steps are not compared: the gathers' backward adds with atomics, so the
    program's own runs of one seed part after the first update, and the
    chaotic warps read up to 1.6e-4 there between two runs of one seed
    (``loss_gap_steps``, printed beside the checks)."""
    names = list(ref["first_grad"])
    moved = compare.moved_leaves(ref["first_grad"], names)
    stats = [n for n in ref["change"] if n not in ref["first_grad"]]
    return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"], 1),
            "grad_gap": compare.leaf_gap(prog["first_grad"], ref["first_grad"], names)[0],
            "change_gap": compare.leaf_gap(prog["change"], ref["change"], moved + stats)[0]}


def run(cell, seed: int, seconds: float, trace: bool, device):
    import torch

    traffic = cell.traffic
    b = traffic["batch_size"]
    state, step, gen, batches, prog = program_setup(cell, seed, device)
    torch.cuda.synchronize(device)

    timer = StageTimer(trace)
    t_start = time.perf_counter()
    stretch = Stretch(trace, traffic["profile_steps"], t_start + seconds / 2)
    deadline, i, losses = t_start + seconds, traffic["reference_steps"], []
    while time.perf_counter() < deadline:
        stretch.begin_step()
        if not stretch.active:
            timer.start()
        state, metrics = step(state, batches[i % len(batches)], gen, stage=timer.mark)
        timer.stop()
        stretch.end_step(b)
        losses.append(metrics["loss"])
        i += 1
    torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    stages = timer.ms() if trace else None
    print(json.dumps({"steps": len(losses), "ms_per_step": window_s * 1e3 / len(losses),
                      "stage_ms_mean": stages and {k: statistics.fmean(v)
                                                   for k, v in stages.items()}}))
    ctx = {"kind": KIND, "stage_ms": stages, "trace": stretch.trace,
           "select_bound_s": counts.select_bound_s(
               counts.select_sites(cell.config, b, training=True),
               harness.HBM_BYTES_PER_S, harness.F32_FLOPS_PER_S),
           "flops_per_sample": counts.flops_per_sample(cell.config, training=True),
           "samples": len(losses) * b - stretch.samples,
           "untraced_s": stretch.outside(window_s), "stretch_samples": stretch.samples,
           "stretch_s": stretch.seconds}
    del state, step, gen, metrics, losses
    gc.collect()
    torch.cuda.empty_cache()
    return {"setup_end": t_start, "window_s": window_s, "attempted": i - traffic["reference_steps"], "failed": failed,
            "peak_bytes": peak, "ctx": ctx,
            "e2e": {"train_samples_per_s": (i - traffic["reference_steps"]) * b / window_s},
            "judge": lambda: judge(prog, cell, seed, batches, device)}


def judge(prog: Dict, cell, seed: int, batches, device) -> Dict[str, float]:
    ref = reference_readings(cell, seed, batches, device)
    steps = cell.traffic["reference_steps"]
    print(json.dumps({"loss_gap_steps": compare.loss_gap(prog["losses"], ref["losses"], steps)}))
    return checks(prog, ref)
