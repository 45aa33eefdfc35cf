"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Refuse to run without a CUDA card; turn TF32 off (the reference is fp32);
   print the card's name and power limit.
2. Build every kernel library of the port from its source in this checkout,
   one nvcc per source, all started together, and print the build seconds.
3. Kernel phase: each kernel at the main paths' shapes against its plain
   PyTorch version on the same inputs, with its tolerance; times by CUDA
   events (median after a warm-up) beside the bound for the same work.
   K1 (the inner loop) at E = 8, then at E = 1, 2, 4 and 8 (the batches of
   MMN ``serve_episode``, the MMN train step, MMN eval and CWT; each
   partitions an episode differently), each held against the plain version
   and against the E = 8 launch's bits, and timed, with the work plan it
   launched (grid, CTAs per episode); K2 (the same function, 2
   episodes per CTA) on K1's inputs, against the plain version and against
   K1, with its shared memory and the tile ``pick_tile`` gives for
   FSS_INNER_TILE 2 and 4 (3c); then the
   centre-pivot pair (pivot_fwd, pivot_dw) for each consensus block at 473 px
   (2->10, 10->10, 10->1), its gradients held against an fp64 run, beside the
   rank-4 route's cuDNN time, pivot_fwd also timed at each block's dx shape
   (10->2, 10->10, 1->10), with pivot_dw's time over the plain version's
   (cuDNN's weight gradient) and the bound and its kind: the bytes, or the
   operations at the lesser of fp32 on the CUDA cores and 3xTF32 on the
   tensor cores (3b). K1 at E = 8 and shot 5 (episode 0 with an all-255
   padded shot) against the plain loop, timed beside its bound, with the
   plan it launched (3d).
4. CWT main path at full width: ResNet-50 PSPNet + CWT with a seeded random
   init, 8 synthetic 1-shot episodes at 473 px, adapt_iter 200. First, at
   the raw init, the kernel and the plain loop in fp32 (card and host) are
   each held against the plain loop in fp64 on the same features
   (``raw_init_witness``: the loop is chaotic at those feature norms).
   Then the BN statistics are calibrated on other synthetic episodes. The
   launch counts are set to 0 just before ``serve_batch`` +
   ``eval_metrics_batch`` and read just after; every kernel must have
   launched, and K1's launched plan must spread an episode over more than
   one CTA. The same episodes
   and classifier inits then go through the plain inner loop and the masks
   must agree on >= 99.5% of pixels. Episodes/s for serve and eval. Then
   (4b) serve of the same 8 under ``compute_dtype bfloat16`` and under
   ``bf16_stages stem,layer1,layer2`` on copies of the calibrated backbone,
   counted (K1 gets fp32 features), with episodes/s, the backbone's time,
   peak memory and the masks' agreement with fp32.
5. The evaluation entry point ``train.test.main`` on configs/pascal.yaml
   with synthetic episodes; its mIoU line is printed.
6. MMN head at full width, configs/pascal_mmn.yaml as shipped (``use_amp
   True``: bf16 backbone with BN calibrated in fp32, fp32 head in eval and
   serve, bf16 head in the train step; 1-shot, 473 px, adapt_iter 200, 4
   episodes): eval + serve (batch and one episode) on the flat route with
   the counts reset around them (K1 and pivot_fwd must launch),
   predictions against the rank-4 route (argmax agreement >= 99.5% for
   pred and pred1), episodes/s on both routes and where the time goes. Then
   one training step's head gradients on the flat route (pivot_dw must
   launch) against the rank-4 route's: with the head in fp32 within 1e-3
   of each tensor's largest entry, and with the bf16 head (use_amp) within
   5e-2 or twice the rank-4 route's own bf16 spread (its distance from the
   fp32-head step), per tensor in the L2 norm; timed optimizer steps with
   dropout on. Then
   (6b) the train step of 2 at shot 5 on the flat route, counted, with the
   k-shot defaults and, where their peak memory leaves room, ``shot_tile
   5`` and ``shot_native``: episodes/s and peak memory of each. (6c) On
   the same engine: one train step of 2 with ``meta_aug 2`` and
   ``att_type 3`` (two views a support, the better one read; pivot_dw must
   launch), and eval of 4 with ``eval_episode_tile 2`` (masks and I/U
   equal to the untiled run's). (6d) The match head, configs/
   pascal_match.yaml as shipped (ResNet-50, ``rmid mid4``, ``crm_type nc``,
   cycle mask at eval, cosine classifier, fp32; BN statistics and
   consensus biases calibrated as for MMN): the pivot pair at its first
   block's new shape 1 -> 10 as in 3b; eval + serve of 4 and a train step
   of 2 on the rank-4, flat and 6D routes, counted (K1 on every route, the
   pivot kernels on the flat route only), argmax of pred and pred1 >= 99.5%
   equal to rank-4's, gradients within 1e-3 of each tensor's largest
   entry, episodes/s and peak memory; then ``conv4d cv4`` on each
   ``FSS_CONV4D_IM2COL`` route (q, qp, gemm, loop): an eval batch of 2 and
   a train step of 2, predictions within 1e-4 and gradients within 1e-3 of
   the q route's, ms and peak memory of each.
7. The trainer entry points ``train.train_head.main`` on pascal_mmn.yaml as
   shipped and ``train.train_kshot.main`` at shot 5, with synthetic
   episodes; their validation lines are printed.
8. CWT meta-train step at full width (configs/pascal.yaml, 8 episodes, the
   calibrated engine of phase 4). With every dropout off, one step's
   transformer gradients on the K1 path (FSS_INNER_TILE unset), on the K2
   path (FSS_INNER_TILE=2) and with the plain inner loop called directly,
   held against each other; the launch counts are reset around each path
   (K1 launches on the first, K2 and not K1 on the second). Then timed SGD
   steps with dropout on at both tiles (episodes/s, peak memory, the loss
   over the steps on one batch) and a torch.profiler breakdown of each.
   (8b) CWT at shot 5 (a padded shot): eval + serve of 8, counted, masks
   against the plain inner loop; the train step of 8 with FSS_INNER_TILE
   unset and 2 (K2 is 1-shot only, as in the JAX package: both launch K1),
   gradients against the plain loop's, episodes/s and peak memory. (8c)
   ``eval.ab_dtype.run_ab`` over 16 episodes on the calibrated backbone:
   mIoU fp32 / bf16 and the share of mask pixels that agree.
9. The trainer entry point ``train.train_cwt.main`` on pascal.yaml with
   synthetic episodes: one epoch with checkpoints into a scratch model_dir
   under build/, a resume from its ``train_state.pth`` for one more epoch,
   and ``train.test.main`` loading the ``best.pth`` it wrote.
10. Real data: a PASCAL-layout tree of 48 PNG images at VOC sizes (500x375, 375x500,
    500x333) and gray PNG masks with 1-3 objects of split-0 classes, written
    here with zlib (every PNG row filter type in turn), under build/. With
    ``cv2`` and ``PIL`` blocked (their import fails; configs/pascal.yaml
    needs neither):
    ``train.test.main`` on configs/pascal.yaml at 473 px, 2 runs x 64
    episodes in batches of 8, 4 decode threads (K1 must launch). Feed
    timings for the fp32 and the bf16 backbone: loader-fed eval episodes/s
    against the same batches pre-collated on the card, the host's wait per
    batch, the loader alone, one batch's copy from pinned and from pageable
    memory. A 32-episode log replayed twice (2 runs x 16): equal per-class
    lines both times, and run 2 scores log episodes 16-31 (their classes
    alone). ``train_cwt.main`` (debug, FSS_INNER_TILE=2: K2 must launch).
    Then, with cv2 (``resize_np`` is cv2's resize, as in the JAX package):
    ``train_head.main`` on configs/pascal_mmn.yaml as shipped on the flat
    route (pivot_fwd and pivot_dw must launch); ``train_match.main`` on
    configs/pascal_match.yaml on the flat route (K1 and both pivot kernels
    must launch), one epoch with its train state saved, then a ``debug``
    run resuming from it for the second epoch. Every trainer's ``log.txt``
    must hold its validation line (train_cwt's in phase 9, train_head's in
    phase 7 and here, pretrain's in 11b, whose TensorBoard scalars must
    hold ``train_loss`` and ``mean_iou/val``). The tools on the tree:
    ``tools.preflight`` exits 0 with a stage-1 and a CWT ``.pth`` saved from
    the random init and 1 without the stage-1 one; ``utils.convert_ckpt
    strip-module`` then ``to-port`` give back the state_dict;
    ``tools.bench_loader`` prints its line. ``record_episodes`` and
    ``parity_drill`` need the reference tree, which is not here.
11. Stage-1 pretraining, VGG and the bench: (a) the pretrain step at full
    width (configs/pascal_pretrain.yaml: ResNet-50, 473 px, batch 10, 16
    classes, label smoothing, scale_lr 2), plain and with mixup: finite
    losses, images/s, ms a step, peak memory; (b) ``train.pretrain.main`` on
    a PNG tree (as in 10; 4 decode threads), one epoch with standard
    validation and one with episodic validation (K1 must launch), then
    ``train.test.main`` loading the ``best.ckpt`` it wrote from the stage-1
    schema (it must log ``=> loaded weight``); (c) an episodic eval batch of
    8 with ``arch vgg``: K1 at VGG's 30x30 features against the plain loop
    (1e-4 * max|acc|), masks against the plain loop's (>= 99.5%), K1 timed
    beside its bound; (d) ``tools.bench.run`` in every mode with 5 timed
    batches (MMN modes on the flat route, the CWT train step at
    FSS_INNER_TILE=2), each JSON line printed.
12. The serve artifacts (``tools.export_serve``): the CWT serve program at
    batch 8 on phase 4's calibrated weights and the MMN one
    (configs/pascal_mmn.yaml as shipped, flat route) at batch 4 on phase
    6's, each exported with ``torch.export`` around the ``fss::``
    operators, saved, and loaded in a fresh process that imports only
    torch and the port's ``ops`` (``tools.serve_loaded``): its masks >=
    99.5% equal to eager ``serve_batch``'s, K1 (and for MMN pivot_fwd)
    launched there; export seconds, size and episodes/s loaded vs eager
    (the serving process turns TF32 off, as the entry points do; the CWT
    artifact also runs once with TF32 on, printed without a limit).
    Then ``validate_transformer`` with ``profile_dir`` (1 run x 16
    episodes): its torch.profiler trace must name K1's kernel.
13. Scale-out (``parallel/dryrun.py``, TF32 off in every process): with
    two or more cards NCCL over ``min(cards, 4)`` processes, one a card;
    with one card two processes on ``cuda:0`` over gloo, named explicitly
    (NCCL refuses two ranks on one card), printed before anything runs. At
    473 px on the calibrated weights of phases 4 and 6: the CWT train step
    of 8 episodes on the K1 path and on K2 (FSS_INNER_TILE=2), every
    dropout off, gradients within 1e-3 of each tensor's largest entry of
    one process's step on the same 8 episodes and inits; the MMN step of
    configs/pascal_mmn.yaml as shipped (2 episodes, flat route, head
    dropout off) at phase 6's fp32 (1e-3) and bf16 (L2, max(5e-2, twice
    the bf16 head's spread)) limits against one process running the ranks'
    slices one after another (the backbone's results depend on the batch it
    runs, and the head's gradients amplify that: the distance from one
    process on the whole batch is printed beside it); the stage-1 step at
    batch 10 (pascal_pretrain.yaml, seeded weights, dropout and mixup off)
    within 3x the distance between two computations of it in one process
    (its rerun on the batch permuted; torch's batch norm against the
    global-batch BN; 1e-6 at least), BN running statistics within 1e-5 of
    each tensor's largest entry; parameters after each step equal on every
    rank, bit for bit; one eval batch of 8 gathered against one process's
    run with each rank's inits, ``validate_transformer`` and
    ``episodic_validate``; the same steps in one process over NCCL (a group
    of one). Each step's ms per rank, the gradient all-reduce's ms and
    bytes, peak GiB per rank, and each rank's launches of K1, K2,
    pivot_fwd and pivot_dw (every one above 0) beside one process's. Then
    ``torchrun`` of ``train.train_ddp`` and ``train.train_cwt`` on
    synthetic episodes: one epoch saved, a second launch resuming it;
    rank 0 alone writes each ``log.txt``.
14. A ``kernels`` JSON line (with each kernel's launches on the real-data
    path, K1's in (b)'s episodic validation and its VGG figures, the
    match head's launches and the pivot pair's figures at 1 -> 10, the
    loaded artifacts' launches, and the launches per rank of phase 13
    under ``scale_out``), the card line, and as the last line
    ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn as nn

# the card's peaks, the kernels' work and bounds, and the card line: shared
# with the port's bench
from few_shot_seg_cwt_tpu_torch.tools.roofline import (PEAK_FP32_FLOPS, PEAK_HBM_BYTES,
                                                       PEAK_TF32_FLOPS, bound, card_line,
                                                       inner_loop_work, pivot_work)

E, SHOT, IMG, FEAT, CH, STEPS, CLS_LR = 8, 1, 473, 60, 512, 200, 0.1
TILE = 2                                     # K2's episodes per CTA at 473 px
E_MMN = 4                                    # MMN episodes per eval/serve batch
SHOT5 = 5                                    # the k-shot paths' shot count
MIXED = "stem,layer1,layer2"                 # the mixed bf16 stage policy
PIVOT_BLOCKS = ((2, 10), (10, 10), (10, 1))  # NeighConsensus (Ci, Co), rmid l34
PIVOT_DIMS = (FEAT, FEAT, FEAT, FEAT)
ROUTE_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4",
                  "FSS_INNER_TILE")


def host_seconds(fn, reps: int) -> float:
    """Median host seconds of ``fn()`` ending in a synchronise."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def launch_and_op_ms(raw, op, reps: int = 7) -> dict:
    """A kernel's bare ctypes launch ``raw()`` beside the ``fss::`` operator
    call ``op()`` that wraps it, on the same inputs, interleaved in one loop.
    Median CUDA-event ms with the stream idle at each start event, as
    ``cuda_ms`` times (``ms``, ``op_ms``: the host's time to issue the call
    shows in them); the same with the stream kept busy by a 1 ms spin while
    the host issues (``queued_ms``, ``op_queued_ms``: device time alone);
    and median host microseconds from the call to its return (``host_us``,
    ``op_host_us``). The operator's dispatch a launch is
    ``op_host_us - host_us``."""
    raw(), op()
    torch.cuda.synchronize()
    keys = ("ms", "op_ms", "queued_ms", "op_queued_ms", "host_us", "op_host_us")
    got = {k: [] for k in keys}
    for _ in range(reps):
        for queued in (False, True):
            for pre, fn in (("", raw), ("op_", op)):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if queued:
                    torch.cuda._sleep(2_000_000)      # ~1 ms of cycles
                start.record()
                t0 = time.perf_counter()
                fn()
                host_us = 1e6 * (time.perf_counter() - t0)
                end.record()
                torch.cuda.synchronize()
                got[pre + ("queued_ms" if queued else "ms")].append(start.elapsed_time(end))
                if not queued:
                    got[pre + "host_us"].append(host_us)
    out = {k: statistics.median(v) for k, v in got.items()}
    out["dispatch_us"] = out["op_host_us"] - out["host_us"]
    return out


def dispatch_text(t: dict) -> str:
    """One line of ``launch_and_op_ms``'s figures."""
    return (f"bare launch {t['ms']:.3f} ms / operator {t['op_ms']:.3f} ms (idle stream), "
            f"{t['queued_ms']:.3f} / {t['op_queued_ms']:.3f} ms (host ahead: device time), "
            f"host {t['host_us']:.1f} / {t['op_host_us']:.1f} us a call: dispatch "
            f"{t['dispatch_us']:.1f} us a launch")


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, images: torch.Tensor) -> None:
    """Set every BN's running statistics to those of ``images`` (NHWC).

    A random init has unit running variances, so activations grow through
    the 16 residual blocks and the features come out with per-pixel norms in
    the thousands, where the 200-step inner loop at cls_lr 0.1 is chaotic.
    One pass in train mode with cumulative averaging gives the statistics a
    trained network would carry, and features of a trained network's scale.
    The model is left in eval mode.
    """
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average over the calibration pass
    model.train()
    try:
        # the bottleneck's channel dropout is live in train mode; its mask
        # does not reach the statistics
        model.extract_features(images, torch.Generator().manual_seed(0))
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        model.eval()


@torch.no_grad()
def raw_init_witness(engine, batch, w0, cuda_inner_loop, binary_pixel_weights):
    """The kernel and two plain fp32 loops (on the card and on the host), each
    against the plain loop in fp64, on the raw random init's features
    (per-pixel norms in the thousands).

    After 1 step the loop is not yet chaotic: all three must be within 1e-5
    relative of fp64. Later, rounding is amplified step by step, so the two
    plain fp32 loops measure how far a correct fp32 order drifts. The kernel's
    acc may drift from fp64 at most 4x as far as the farther plain loop's, at
    every step count; after 200 steps its masks may differ from the fp64
    masks at most 3x as often as the plain loops' do, plus 0.5% of pixels.
    """
    f_s, f_q = engine._episode_features(batch)
    pw, pwy = binary_pixel_weights(batch["s_label"])
    u0 = (w0[:, 1] - w0[:, 0]).contiguous()
    host = [t.cpu() for t in (f_s, pw, pwy, u0)]
    wide = [t.double() for t in (f_s, pw, pwy, u0)]
    norm = float(f_s.norm(dim=-1).median())
    size = tuple(batch["q_label"].shape[-2:])

    def mask(acc):
        acc = acc.to(f_q.device, torch.float32)
        w = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
        return engine.mask_from_prediction(engine._predict(f_q, w)[0], size)

    rows = []
    for steps in (1, 10, 50, STEPS):
        acc_64 = cuda_inner_loop.adapt_binary_reference(*wide, steps, CLS_LR)
        accs = {
            "kernel": cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, CLS_LR),
            "plain_gpu": cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, CLS_LR),
            "plain_cpu": cuda_inner_loop.adapt_binary_reference(*host, steps, CLS_LR),
        }
        m_64 = mask(acc_64)
        rel, diff, per_ep = {}, {}, {}
        for name, acc in accs.items():
            acc = acc.to(acc_64.device, torch.float64)
            rel[name] = float((acc - acc_64).abs().max() / acc_64.abs().max())
            ne = (mask(acc) != m_64).float().mean(dim=(1, 2))
            diff[name], per_ep[name] = float(ne.mean()), [round(float(x), 5) for x in ne]
        rows.append({"steps": steps, "rel_acc_vs_fp64": rel,
                     "mask_diff_vs_fp64": diff, "per_episode_mask_diff": per_ep})
    print(f"raw init (median per-pixel feature norm {norm:.1f}): kernel and plain "
          f"fp32 inner loops vs plain fp64, by steps: {json.dumps(rows)}")
    if max(rows[0]["rel_acc_vs_fp64"].values()) > 1e-5:
        raise AssertionError(f"after 1 step at raw-init norms an fp32 loop is off "
                             f"fp64 by more than 1e-5 relative: {rows[0]}")
    for row in rows[1:]:
        rel = row["rel_acc_vs_fp64"]
        if rel["kernel"] > 4 * max(rel["plain_gpu"], rel["plain_cpu"]):
            raise AssertionError(f"the kernel drifts from fp64 over 4x as far as the "
                                 f"plain fp32 loops: {row}")
    diff = rows[-1]["mask_diff_vs_fp64"]
    allowed = 3 * max(diff["plain_gpu"], diff["plain_cpu"]) + 0.005
    if diff["kernel"] > allowed:
        raise AssertionError(f"after {STEPS} steps the kernel's masks differ from fp64 "
                             f"on {diff['kernel']:.4%} of pixels, more than the "
                             f"allowed {allowed:.4%}")
    return norm


@contextlib.contextmanager
def env_var(name: str, value):
    """``name`` set to ``value`` (unset for None) for the enclosed calls."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def pivot_route(flat: bool):
    """The consensus route for the enclosed calls: flat (the pivot kernels,
    ``FSS_PIVOT_MXU=1``) or rank-4 (cuDNN plane convs, the default)."""
    return env_var("FSS_PIVOT_MXU", "1" if flat else None)


def inner_tile(tile):
    """The inner loop's episodes per CTA for the enclosed calls: K1 (None,
    FSS_INNER_TILE unset) or K2 (``FSS_INNER_TILE=tile``)."""
    return env_var("FSS_INNER_TILE", None if tile is None else str(tile))


def pivot_grads(fn, x, wa, wb, bias, t, dtype=torch.float32):
    """(dx, dwa, dwb, db) of sum(fn(...) * t), ReLU off.

    With the ReLU on, the few of the 13 M positions whose output lies
    within rounding of 0 are masked differently in fp32 and fp64, and each
    such flip moves db and dx by a whole |t| ~ 1, far above rounding; so the
    fp64 witness runs the linear pair. The ReLU's mask (applied in Python
    before the kernels) is held on the MMN path: flat against rank-4 grads."""
    leaves = [a.to(dtype).clone().requires_grad_(True) for a in (x, wa, wb, bias)]
    (fn(*leaves, PIVOT_DIMS, relu=False) * t.to(dtype)).sum().backward()
    return [a.grad for a in leaves]


def pivot_phase(cuda_pivot, cuda_ms, CenterPivotConv4d, card, blocks=PIVOT_BLOCKS):
    """Each consensus block at 473 px: pivot_fwd with the ReLU against the
    plain version (max|y_k - y_p| <= 1e-5 max|y_p|); the operator's
    gradient: dx (pivot_fwd with flipped weights) and (dwa, dwb, db) (pivot_dw) against
    autograd of the plain version, both held against an fp64 run (see
    ``pivot_grads``): the kernels may be at most 4x as far from fp64 as the
    plain fp32 version, plus 2e-6 of the largest entry. The slack covers the
    short sums: dx adds 18*Co <= 180 products per output in one fp32 chain,
    good to ~1e-6 relative, while cuDNN's tree sums come closer; for the
    13 M-term dW sums it is far below the plain version's own error.
    Times the bare launches of pivot_fwd at the forward shape and at the
    block's dx shape (Ci and Co swapped) and of pivot_dw, the first and the
    last beside their operators (``launch_and_op_ms``). Returns per-block
    numbers."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    q = s = FEAT * FEAT
    out = {}
    for ci, co in blocks:
        x = torch.tensor(rng.standard_normal((1, ci, q, s), dtype=np.float32), device=dev)
        w = (rng.standard_normal((2, 3, 3, ci, co)) / np.sqrt(18 * ci)).astype(np.float32)
        wa, wb = (torch.tensor(a, device=dev) for a in w)
        bias = torch.tensor(rng.standard_normal(co, dtype=np.float32), device=dev)
        t = torch.tensor(rng.standard_normal((1, co, q, s), dtype=np.float32), device=dev)
        ref = cuda_pivot.pivot_conv_flat_reference

        y_k = cuda_pivot.pivot_fwd(x, wa, wb, bias, PIVOT_DIMS, relu=True)
        y_p = ref(x, wa, wb, bias, PIVOT_DIMS, relu=True)
        fwd_err, fwd_scale = float((y_k - y_p).abs().max()), float(y_p.abs().max())
        del y_k, y_p
        g_k = pivot_grads(cuda_pivot.pivot_fwd, x, wa, wb, bias, t)
        g_p = pivot_grads(ref, x, wa, wb, bias, t)
        g_64 = pivot_grads(ref, x, wa, wb, bias, t, torch.float64)
        torch.cuda.synchronize()
        grads = {}
        for name, k, p, r in zip(("dx", "dwa", "dwb", "db"), g_k, g_p, g_64):
            grads[name] = {"kernel_vs_fp64": float((k.double() - r).abs().max()),
                           "plain_vs_fp64": float((p.double() - r).abs().max()),
                           "kernel_vs_plain": float((k - p).abs().max()),
                           "scale": float(r.abs().max())}
        del g_k, g_p, g_64
        dw_err = max(grads[n]["kernel_vs_plain"] for n in ("dwa", "dwb", "db"))
        print(f"pivot {ci}->{co}: pivot_fwd max|y_k - y_p| = {fwd_err:.3e} (tolerance "
              f"1e-5 * max|y_p| = {1e-5 * fwd_scale:.3e}, ReLU on); gradients (ReLU off) vs fp64: "
              f"{json.dumps(grads)}")
        if not np.isfinite(fwd_err) or fwd_err > 1e-5 * fwd_scale:
            raise AssertionError(f"pivot_fwd {ci}->{co} disagrees with its plain version")
        for name, g in grads.items():
            if not g["kernel_vs_fp64"] <= 4 * g["plain_vs_fp64"] + 2e-6 * g["scale"]:
                raise AssertionError(f"pivot {ci}->{co} {name}: the kernel is over 4x as far "
                                     f"from fp64 as the plain fp32 version (+2e-6 of the "
                                     f"scale): {g}")

        lib = cuda_pivot.load_library()
        fwd_t = launch_and_op_ms(
            lambda: cuda_pivot.launch_fwd(lib, x, wa, wb, bias, PIVOT_DIMS, True),
            lambda: cuda_pivot.pivot_fwd(x, wa, wb, bias, PIVOT_DIMS, True))
        fwd_ms = fwd_t["ms"]
        fwd_plain_ms = cuda_ms(lambda: ref(x, wa, wb, bias, PIVOT_DIMS, True), 5)
        dw_t = launch_and_op_ms(lambda: cuda_pivot.launch_dw(lib, x, t, PIVOT_DIMS),
                                lambda: cuda_pivot.pivot_dw(x, t, PIVOT_DIMS))
        dw_ms = dw_t["ms"]
        dw_plain_ms = cuda_ms(lambda: cuda_pivot.pivot_dw_reference(x, t, PIVOT_DIMS), 5)
        blk = CenterPivotConv4d(ci, co).to(dev)
        with torch.no_grad():
            blk.conv1.weight.copy_(wa.permute(3, 2, 0, 1))
            blk.conv2.weight.copy_(wb.permute(3, 2, 0, 1))
            blk.conv1.bias.copy_(bias)
            blk.conv2.bias.zero_()
            xr = x.permute(0, 2, 3, 1).contiguous()         # (1, Q, S, Ci)
            r4_ms = cuda_ms(lambda: blk(xr, False, True, PIVOT_DIMS, bqsc=True), 5)
        # dx in the backward: pivot_fwd of the cotangent with the flipped,
        # transposed weights, Ci and Co swapped, a zero bias, no ReLU
        fwa, fwb = cuda_pivot.flip_t(wa), cuda_pivot.flip_t(wb)
        zeros = torch.zeros(ci, device=dev)
        dx_ms = cuda_ms(lambda: cuda_pivot.launch_fwd(lib, t, fwa, fwb, zeros, PIVOT_DIMS), 5)
        dx_plain_ms = cuda_ms(lambda: ref(t, fwa, fwb, zeros, PIVOT_DIMS), 5)
        del xr, x, t
        torch.cuda.empty_cache()
        flops, nbytes = pivot_work(ci, co, q, s)
        b_ms, b_by = bound(flops, nbytes, tensor_cores=True)
        print(f"pivot {ci}->{co}: pivot_fwd {fwd_ms:.3f} ms (plain {fwd_plain_ms:.3f} ms), "
              f"pivot_dw {dw_ms:.3f} ms (plain {dw_plain_ms:.3f} ms), rank-4 route "
              f"forward (2 cuDNN conv2d + permute) {r4_ms:.3f} ms; bound {b_ms:.3f} ms "
              f"({b_by}: {flops / 1e9:.2f} GFLOP / 67 TFLOP/s = "
              f"{flops / PEAK_FP32_FLOPS * 1e3:.3f} ms or as 3xTF32 / 495 TFLOP/s = "
              f"{3 * flops / PEAK_TF32_FLOPS * 1e3:.3f} ms, {nbytes / 1e9:.3f} GB / "
              f"3.35 TB/s = {nbytes / PEAK_HBM_BYTES * 1e3:.3f} ms) for each kernel; "
              f"library_ms null [{card}]")
        print(f"pivot {ci}->{co}: dx, pivot_fwd {co}->{ci} (flipped weights, no ReLU) "
              f"{dx_ms:.3f} ms (plain {dx_plain_ms:.3f} ms); bound {b_ms:.3f} ms ({b_by}, "
              f"the forward's counts), fp32 FMA floor {flops / PEAK_FP32_FLOPS * 1e3:.3f} "
              f"ms [{card}]")
        print(f"pivot {ci}->{co}: pivot_dw / cuDNN wgrad (the plain version, TF32 off) = "
              f"{dw_ms:.3f} / {dw_plain_ms:.3f} ms = {dw_ms / dw_plain_ms:.3f}; "
              f"{b_ms / dw_ms:.1%} of the {b_by} bound [{card}]")
        print(f"pivot {ci}->{co}: pivot_fwd {dispatch_text(fwd_t)}; pivot_dw "
              f"{dispatch_text(dw_t)} [{card}]")
        out[(ci, co)] = dict(fwd_err=fwd_err, dw_err=dw_err, fwd_ms=fwd_ms, fwd_t=fwd_t,
                             dw_t=dw_t, fwd_plain_ms=fwd_plain_ms, dw_ms=dw_ms,
                             dw_plain_ms=dw_plain_ms,
                             dx_ms=dx_ms, dx_plain_ms=dx_plain_ms,
                             r4_ms=r4_ms, bound_ms=b_ms, bound_by=b_by)
    return out


@torch.no_grad()
def calibrate_blocks(consensus, x):
    """Set each block's bias of ``consensus`` so that half of its outputs on
    the flat volume ``x`` (after mutual matching) are positive (median
    pre-activation per output channel at 0), block after block; conv2's
    bias stays 0."""
    for blk in list(consensus.conv)[::2]:
        blk.conv1.bias.zero_()
        blk.conv2.bias.zero_()
        pre = blk(x, False, False, PIVOT_DIMS)
        med = pre[0].flatten(1).median(dim=1).values
        blk.conv1.bias.copy_(-med)
        x = torch.relu(pre - med.view(1, -1, 1, 1))
    print(f"consensus calibration: block biases "
          f"{[round(float(b), 5) for blk in list(consensus.conv)[::2] for b in blk.conv1.bias[:2]]} "
          f"(first two channels each)")


@torch.no_grad()
def calibrate_consensus(engine, calib_episodes, get_corr):
    """Calibrate the consensus biases of an MMN or match engine on a
    calibration episode's correlation volume (``calibrate_blocks``).

    With the seeded random init (zero biases) the last block's ReLU can zero
    the whole filtered volume: the readout is then a plain average over the
    support and neither route's consensus reaches the prediction. This gives
    the consensus the live units a trained one has, as ``calibrate_batchnorm``
    does for the backbone. Runs on the flat route.
    """
    from few_shot_seg_cwt_tpu_torch.episodic.heads import match_stage
    from few_shot_seg_cwt_tpu_torch.ops.corr import mutual_matching, mutual_matching_flat

    batch = engine.to_device({k: v[:1] for k, v in calib_episodes.items()})
    w0 = engine.init_weights(1, torch.Generator().manual_seed(9))
    part = engine._one(engine.episode_parts(batch, w0), batch, 0)[0]
    head = engine.head
    if engine.head_type == "match":
        key = match_stage(engine.cfg)
        corr = get_corr(part["fq_feats"][key][-1], part["fs_feats"][key][-1])[:, None]
        consensus = head.NeighConsensus
        if consensus.conv_type == "cv4":
            # the true 4D conv has one bias and runs on the 6D layout
            x = mutual_matching(corr.reshape((1,) + PIVOT_DIMS + (1,)))
            for blk in list(consensus.conv)[::2]:
                blk.bias.zero_()
                pre = blk(x)
                med = pre.flatten(0, 4).median(dim=0).values
                blk.bias.copy_(-med)
                x = torch.relu(pre - med)
            print(f"cv4 consensus calibration: block biases "
                  f"{[round(float(b), 5) for blk in list(consensus.conv)[::2] for b in blk.bias[:2]]}")
            return
    else:
        corr = torch.stack([get_corr(q, s) for q, s in zip(
            head.prep_query(part["fq_feats"]), head.prep_query(part["fs_feats"]))], dim=1)
        consensus = head.corr_net.NeighConsensus
    calibrate_blocks(consensus, mutual_matching_flat(corr))


def device_profile(fn, label, card, groups=()):
    """One call of ``fn`` under torch.profiler (CUPTI): device ms per kernel,
    the port's kernels summed by name, the top others, and the device's idle
    share of the wall time (one stream, so kernel times do not overlap).
    ``groups``: (name, substrings) pairs; the other kernels whose names hold
    one of a group's substrings are summed under its name (first match)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ms = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            ms[ev.key] = ms.get(ev.key, 0.0) + us / 1e3
    busy = sum(ms.values())
    if busy <= 0:
        print(f"{label}: the profiler recorded no device time (not measured)")
        return
    patterns = (("K1 adapt_binary", "adapt_binary_kernel"),
                ("K2 adapt_binary_tiled", "adapt_binary_tiled_kernel"),
                ("pivot_fwd", "pivot_fwd_kernel"), ("pivot_dw", "pivot_dw_"))
    ours = {name: sum(v for k, v in ms.items() if pat in k) for name, pat in patterns}
    others = sorted(((v, k) for k, v in ms.items()
                     if not any(pat in k for _, pat in patterns)), reverse=True)[:6]
    grouped = {}
    for k, v in ms.items():
        if any(pat in k for _, pat in patterns):
            continue
        name = next((g for g, subs in groups if any(sub in k for sub in subs)), "rest")
        grouped[name] = grouped.get(name, 0.0) + v
    print(f"{label}: wall {wall:.1f} ms, device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall:.1%}); the port's kernels "
          f"{ {k: round(v, 1) for k, v in ours.items()} }; top other kernels "
          f"{[(k[:70], round(v, 1)) for v, k in others]}"
          + (f"; by group {({k: round(v, 1) for k, v in grouped.items()})}" if groups else "")
          + f" [{card}]")


def launch_counts(*modules):
    out = {}
    for m in modules:
        out.update(m.LAUNCHES)
    return out


def mmn_phase(card, calib_images, calib_episodes, cuda_ms, modules):
    """MMN eval/serve on the flat route (counted), against the rank-4 route;
    episodes/s on both; where an eval batch's time goes; one training step's
    gradients on both routes; timed optimizer steps with dropout on."""
    (load_cfg, merge_cfg_from_list, HeadEngine, make_episode_batch, cuda_inner_loop,
     cuda_pivot, adapt_classifier_batch, get_corr, build_optimizer, build_pspnet) = modules
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"),
                              ["episode_batch", str(E_MMN)])
    got = (cfg.image_size, cfg.adapt_iter, cfg.layers, cfg.rmid, cfg.wa, cfg.temp,
           cfg.att_wt, cfg.loss_type, cfg.cls_lr, cfg.conv4d, cfg.shot, cfg.use_amp,
           cfg.meta_aug)
    if got != (IMG, STEPS, 50, "l34", True, 20.0, 0.2, "wt_dc", CLS_LR, "red", 1, True, 1):
        raise AssertionError(f"configs/pascal_mmn.yaml no longer gives the MMN path: {got}")
    # the config as shipped: use_amp runs the backbone in bf16. Its BN
    # statistics are calibrated in fp32, then the engine casts it.
    cfg32 = cfg.clone()
    cfg32.use_amp = False
    backbone = build_pspnet(cfg32).to("cuda")
    calibrate_batchnorm(backbone, calib_images)
    with pivot_route(True):
        engine = HeadEngine(cfg, "mmn", backbone=backbone, device="cuda")
    if {p.dtype for m in engine.backbone.stage_modules().values()
            for p in m.parameters()} != {torch.bfloat16}:
        raise AssertionError("use_amp: the MMN backbone is not bf16")
    with pivot_route(True):
        calibrate_consensus(engine, calib_episodes, get_corr)
    episodes = make_episode_batch(13, E_MMN, size=IMG, shot=SHOT)
    w0 = engine.init_weights(E_MMN, torch.Generator().manual_seed(5))

    # ---- the main path: eval + serve on the flat route, counted ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with pivot_route(True):
        cuda_inner_loop.reset_launches()
        cuda_pivot.reset_launches()
        metrics = engine.eval_metrics_batch(episodes, w0=w0)
        masks = engine.serve_batch(episodes, w0=w0)
        one = engine.serve_episode({k: v[0] for k, v in episodes.items()}, w0=w0[0])
        torch.cuda.synchronize()
        eval_launches = launch_counts(cuda_inner_loop, cuda_pivot)
    print(f"MMN eval_metrics_batch + serve_batch of {E_MMN} + serve_episode launches "
          f"(use_amp, flat route): {eval_launches}; serve_episode vs serve_batch mask "
          f"agreement {float((one == masks[0]).float().mean()):.6f}; peak memory "
          f"{peak_gib():.2f} GiB [{card}]")
    if eval_launches["adapt_binary"] < 1 or eval_launches["pivot_fwd"] < 1:
        raise AssertionError("MMN eval/serve did not launch K1 and pivot_fwd")
    if tuple(masks.shape) != (E_MMN, IMG, IMG) or not set(masks.unique().tolist()) <= {0, 1}:
        raise AssertionError(f"MMN masks {tuple(masks.shape)} {masks.unique().tolist()}")
    # a batch of 1 may take other cuDNN algorithms than a batch of 4
    one_agree = float((one == masks[0]).float().mean())
    if one_agree < 0.995:
        raise AssertionError(f"MMN serve_episode and serve_batch agree on {one_agree:.4%} "
                             "of episode 0's pixels (>= 99.5% needed)")
    for k in ("inter", "union", "inter1", "union1", "inter0", "union0", "loss"):
        if not torch.isfinite(metrics[k].float()).all():
            raise AssertionError(f"MMN eval: non-finite {k}")

    # ---- flat vs rank-4 predictions, same weights and inits ----
    with pivot_route(True):
        p_flat = engine.predict_batch(episodes, w0=w0)
    with pivot_route(False):
        before = cuda_pivot.LAUNCHES["pivot_fwd"]
        p_r4 = engine.predict_batch(episodes, w0=w0)
        torch.cuda.synchronize()
        if cuda_pivot.LAUNCHES["pivot_fwd"] != before:
            raise AssertionError("the rank-4 route launched the pivot kernels")
    agree = {k: float((p_flat[k].argmax(-1) == p_r4[k].argmax(-1)).float().mean())
             for k in ("pred", "pred1")}
    rel = {k: float((p_flat[k] - p_r4[k]).abs().max() / p_r4[k].abs().max())
           for k in ("pred", "pred1")}
    fg = {k: (metrics[f"inter{k}"][:, 1] / metrics[f"union{k}"][:, 1].clamp(min=1))
          .cpu().numpy().round(4).tolist() for k in ("", "1", "0")}
    print(f"MMN flat vs rank-4 route: argmax agreement {agree} (>= 0.995 needed), "
          f"max|p_flat - p_r4| / max|p_r4| {rel}; flat-route per-episode fg IoU of "
          f"pred, pred1 and the adapted classifier alone: {fg}")
    if min(agree.values()) < 0.995:
        raise AssertionError(f"MMN flat and rank-4 routes disagree: {agree}")

    for name, flat in (("flat", True), ("rank-4", False)):
        with pivot_route(flat):
            serve_s = host_seconds(lambda: engine.serve_batch(episodes, w0=w0), 3)
            eval_s = host_seconds(lambda: engine.eval_metrics_batch(episodes, w0=w0), 3)
        print(f"MMN {name} route: serve_batch {E_MMN / serve_s:.3f} episodes/s "
              f"({serve_s * 1e3:.1f} ms per batch of {E_MMN}); eval_metrics_batch "
              f"{E_MMN / eval_s:.3f} episodes/s ({eval_s * 1e3:.1f} ms) [{card}; use_amp "
              f"(bf16 backbone, fp32 head), TF32 off, 1-shot, 473 px, adapt_iter {STEPS}]")

    # ---- where an eval batch's device time goes (flat route) ----
    with torch.no_grad(), pivot_route(True):
        batch = engine.to_device(episodes)
        imgs = torch.cat([batch["s_img"][:, 0], batch["q_img"]])
        t_backbone = cuda_ms(lambda: engine.backbone.extract_features(imgs), 3)
        parts = engine.episode_parts(batch, w0)
        t_k1 = cuda_ms(lambda: adapt_classifier_batch(parts["f_s"], batch["s_label"], w0,
                                                      STEPS, CLS_LR), 1, warmup=0)
        head = engine.head
        ones = [engine._one(parts, batch, i)[0] for i in range(E_MMN)]

        def prep_all():
            return [(head.prep_query(p["fq_feats"]), head.prep_query(p["fs_feats"]))
                    for p in ones]

        t_wa = cuda_ms(prep_all, 3)
        corrs = [torch.stack([get_corr(q, s) for q, s in zip(fq, fs)], dim=1)
                 for fq, fs in prep_all()]
        t_cons = cuda_ms(lambda: [head.corr_net.run_match_model_flat(c, PIVOT_DIMS)
                                  for c in corrs], 3)
        # the filtered correlation itself, flat route against rank-4
        c_flat = head.corr_net.run_match_model_flat(corrs[0], PIVOT_DIMS)
        with pivot_route(False):
            c_r4 = head.corr_net.run_match_model_flat(corrs[0], PIVOT_DIMS)
        c_rel = float((c_flat - c_r4).abs().max() / c_r4.abs().max())
        c_range = (float(c_r4.min()), float(c_r4.max()))
        c_pos = float((c_r4 > 0).float().mean())
        del corrs, c_flat, c_r4
        t_eval = cuda_ms(lambda: engine.eval_metrics_batch(episodes, w0=w0), 2)
    rest = t_eval - t_backbone - t_k1 - t_wa - t_cons
    print(f"MMN consensus output (episode 0), flat vs rank-4 route: max|c_flat - c_r4| / "
          f"max|c_r4| = {c_rel:.3e} (tolerance 1e-4); values in [{c_range[0]:.3e}, "
          f"{c_range[1]:.3e}], {c_pos:.1%} positive")
    if not c_rel <= 1e-4 or c_pos < 0.01:
        raise AssertionError(f"the consensus routes disagree ({c_rel}) or the filtered "
                             f"volume is dead ({c_pos:.2%} positive)")
    print(f"MMN eval batch of {E_MMN} by stage (flat route): backbone {t_backbone:.1f} ms, "
          f"inner loop (K1) {t_k1:.1f} ms, WeightAverage {t_wa:.1f} ms, consensus "
          f"(mutual matching + 2x3 pivot blocks) {t_cons:.1f} ms, correlation, readout, "
          f"classifier, 473 px tail and the rest {rest:.1f} ms; whole batch {t_eval:.1f} ms "
          f"[{card}]")

    with pivot_route(True):
        device_profile(lambda: engine.eval_metrics_batch(episodes, w0=w0),
                       f"MMN eval batch of {E_MMN} (flat route), torch.profiler", card)

    # ---- one training step's gradients: flat route against rank-4 ----
    # With the head in fp32 (use_amp off in the step; the backbone stays
    # bf16, so both routes read the same parts) the routes agree within
    # 1e-3 of each tensor's largest entry. use_amp runs the head in bf16:
    # two bf16 routes each land within bf16 rounding of the fp32 gradient,
    # so per tensor (L2) they may differ by twice the rank-4 route's own
    # distance from its fp32-head step on the same parts, and by 5e-2 in
    # any case.
    e2 = {k: v[:2] for k, v in episodes.items()}
    grads, train_launches = {}, {}
    for name, flat, amp in (("flat", True, True), ("rank-4", False, True),
                            ("flat fp32 head", True, False), ("rank-4 fp32 head", False, False)):
        engine.cfg.use_amp = amp
        with pivot_route(flat):
            cuda_inner_loop.reset_launches()
            cuda_pivot.reset_launches()
            m = engine.backward_batch(e2, w0=w0[:2], deterministic=True)
            torch.cuda.synchronize()
            if flat:
                train_launches[name] = launch_counts(cuda_inner_loop, cuda_pivot)
        if not torch.isfinite(m["loss_mean"]):
            raise AssertionError(f"MMN train step ({name}): non-finite loss")
        grads[name] = {k: p.grad.clone() for k, p in engine.head.named_parameters()}
    engine.cfg.use_amp = True
    print(f"MMN train step launches (flat route, 2 episodes): use_amp {train_launches['flat']}; "
          f"fp32 head {train_launches['flat fp32 head']}")
    for counts in train_launches.values():
        if counts["pivot_dw"] < 1 or counts["pivot_fwd"] < 1:
            raise AssertionError(f"the MMN train step did not launch pivot_dw and pivot_fwd: "
                                 f"{train_launches}")
    g32 = grads["rank-4 fp32 head"]
    scale = {k: float(g.abs().max()) for k, g in g32.items()}
    worst32 = max((float((grads["flat fp32 head"][k] - g).abs().max()) / max(scale[k], 1e-30), k)
                  for k, g in g32.items())
    print(f"MMN fp32 head gradients (bf16 backbone), flat vs rank-4 route: worst "
          f"max|g_flat - g_r4| / max|g_r4| = {worst32[0]:.3e} ({worst32[1]}); tolerance 1e-3; "
          f"max|g_r4| per tensor from {min(scale.values()):.3e} to {max(scale.values()):.3e}")
    if not worst32[0] <= 1e-3:
        raise AssertionError(f"MMN fp32-head gradients differ between routes: {worst32}")
    if not all(np.isfinite(v) and v > 0 for v in scale.values()):
        raise AssertionError(f"MMN fp32-head gradients: a head tensor has zero or non-finite "
                             f"grads {scale}")
    rows = {}
    for k, g in grads["rank-4"].items():
        spread = float((g - grads["rank-4 fp32 head"][k]).norm() / grads["rank-4 fp32 head"][k].norm())
        rows[k] = (float((grads["flat"][k] - g).norm() / g.norm()), spread)
    worst = max(rows.items(), key=lambda kv: kv[1][0] / max(5e-2, 2 * kv[1][1]))
    print(f"MMN bf16 head gradients, flat vs rank-4 route, |g_flat - g_r4| / |g_r4| per tensor "
          f"against the rank-4 route's bf16 spread |g_r4 - g_r4,fp32| / |g_r4,fp32| "
          f"(tolerance max(5e-2, 2 x spread)): worst {worst[0]} {worst[1][0]:.3e} (spread "
          f"{worst[1][1]:.3e}); all {json.dumps({k: [round(a, 5), round(b, 5)] for k, (a, b) in rows.items()})}; "
          f"max|g_r4| per tensor from {min(float(g.abs().max()) for g in grads['rank-4'].values()):.3e} "
          f"to {max(float(g.abs().max()) for g in grads['rank-4'].values()):.3e}")
    bad = {k: v for k, v in rows.items() if not v[0] <= max(5e-2, 2 * v[1])}
    if bad:
        raise AssertionError(f"MMN bf16 gradients differ between routes: {bad}")
    if not all(np.isfinite(float(g.abs().max())) and float(g.abs().max()) > 0
               for g in grads["rank-4"].values()):
        raise AssertionError("MMN gradients: a head tensor has zero or non-finite grads")
    del grads

    # ---- optimizer steps with dropout on (flat route) ----
    opt, sched = build_optimizer(engine.head.parameters(), cfg,
                                 base_lr=cfg.trans_lr * cfg.scale_lr,
                                 iters_per_epoch=max(1, cfg.iter_per_epoch // 2))
    step = engine.make_train_step(opt, sched)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with pivot_route(True):
        for i in range(3):
            t0 = time.perf_counter()
            m = step(e2, torch.Generator().manual_seed(100 + i))
            losses.append(float(m["loss_mean"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    train_s = statistics.median(times[1:])
    print(f"MMN train step (use_amp, flat route, dropout on, SGD): {2 / train_s:.3f} episodes/s "
          f"({train_s * 1e3:.1f} ms per step of 2 episodes; steps {np.round(times, 3).tolist()} s); "
          f"losses {np.round(losses, 4).tolist()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"MMN train steps: non-finite loss {losses}")
    with pivot_route(True):
        device_profile(lambda: step(e2, torch.Generator().manual_seed(200)),
                       "MMN train step of 2 episodes (flat route), torch.profiler", card)
    return engine, eval_launches, train_launches["flat"]


def consensus_route(name: str):
    """The consensus route for the enclosed calls: "rank-4" (the default),
    "flat" (FSS_PIVOT_MXU=1, the pivot kernels) or "6D" (FSS_NCONS_R4=0)."""
    stack = contextlib.ExitStack()
    stack.enter_context(env_var("FSS_PIVOT_MXU", "1" if name == "flat" else None))
    stack.enter_context(env_var("FSS_NCONS_R4", "0" if name == "6D" else None))
    return stack


MATCH_ROUTES = ("rank-4", "flat", "6D")
CV4_ROUTES = ("q", "qp", "gemm", "loop")


def match_phase(card, calib_images, calib_episodes, cuda_ms, modules):
    """The match head, configs/pascal_match.yaml as shipped: the pivot pair
    at its first block's new shape (1 -> 10) against the plain versions;
    eval + serve of E_MMN and a train step of 2 on the rank-4, flat and 6D
    routes (counted; argmax and gradients held against rank-4; episodes/s
    and peak memory); then ``conv4d cv4``'s four routes on one eval batch
    and one train step."""
    (load_cfg, merge_cfg_from_list, HeadEngine, make_episode_batch, cuda_inner_loop,
     cuda_pivot, get_corr, build_pspnet, CenterPivotConv4d) = modules
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_match.yaml"),
                              ["episode_batch", str(E_MMN)])
    got = (cfg.image_size, cfg.adapt_iter, cfg.layers, cfg.rmid, cfg.crm_type, cfg.conv4d,
           cfg.cyc, cfg.sce, cfg.ignore, cfg.temp, cfg.att_wt, cfg.dist, cfg.cls_type,
           cfg.shot, cfg.use_amp)
    if got != (IMG, STEPS, 50, "mid4", "nc", "red", True, False, False, 20.0, 0.2, "cosN",
               "ooo", 1, False):
        raise AssertionError(f"configs/pascal_match.yaml no longer gives the match path: {got}")

    # ---- the pivot pair at the match head's first block, 1 -> 10 ----
    ci1 = pivot_phase(cuda_pivot, cuda_ms, CenterPivotConv4d, card, blocks=((1, 10),))[(1, 10)]

    backbone = build_pspnet(cfg).to("cuda")
    calibrate_batchnorm(backbone, calib_images)
    engine = HeadEngine(cfg, "match", backbone=backbone, device="cuda")
    with consensus_route("flat"):
        calibrate_consensus(engine, calib_episodes, get_corr)
    episodes = make_episode_batch(17, E_MMN, size=IMG, shot=SHOT)
    w0 = engine.init_weights(E_MMN, torch.Generator().manual_seed(6))

    # ---- eval + serve on each route, counted ----
    preds, launches, rates = {}, {}, {}
    for name in MATCH_ROUTES:
        with consensus_route(name):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_inner_loop.reset_launches()
            cuda_pivot.reset_launches()
            metrics = engine.eval_metrics_batch(episodes, w0=w0)
            masks = engine.serve_batch(episodes, w0=w0)
            torch.cuda.synchronize()
            launches[name] = launch_counts(cuda_inner_loop, cuda_pivot)
            peak = peak_gib()
            preds[name] = engine.predict_batch(episodes, w0=w0)
            serve_s = host_seconds(lambda: engine.serve_batch(episodes, w0=w0), 3)
            eval_s = host_seconds(lambda: engine.eval_metrics_batch(episodes, w0=w0), 3)
        rates[name] = dict(eval=E_MMN / eval_s, serve=E_MMN / serve_s, peak_gib=peak)
        for k in ("inter", "union", "inter1", "union1", "loss"):
            if not torch.isfinite(metrics[k].float()).all():
                raise AssertionError(f"match eval ({name}): non-finite {k}")
        if tuple(masks.shape) != (E_MMN, IMG, IMG) or not set(masks.unique().tolist()) <= {0, 1}:
            raise AssertionError(f"match masks ({name}) {tuple(masks.shape)}")
        fg = {k: (metrics[f"inter{k}"][:, 1] / metrics[f"union{k}"][:, 1].clamp(min=1))
              .cpu().numpy().round(4).tolist() for k in ("", "1", "0")}
        print(f"match {name} route: eval_metrics_batch {rates[name]['eval']:.3f} episodes/s "
              f"({eval_s * 1e3:.1f} ms per batch of {E_MMN}), serve_batch "
              f"{rates[name]['serve']:.3f} episodes/s ({serve_s * 1e3:.1f} ms); peak memory "
              f"{peak:.2f} GiB; launches (eval + serve) {launches[name]}; per-episode fg IoU "
              f"of pred, pred1 and the adapted classifier {fg} [{card}; fp32, TF32 off, "
              f"1-shot, 473 px, adapt_iter {STEPS}, cycle mask on]")
        pivots = launches[name]["pivot_fwd"] + launches[name]["pivot_dw"]
        if launches[name]["adapt_binary"] < 1 or (name == "flat") != (pivots > 0):
            raise AssertionError(f"match {name} route launches {launches[name]}: K1 must "
                                 "launch, the pivot kernels on the flat route only")
    for name in ("rank-4", "flat"):
        with consensus_route(name):
            device_profile(lambda: engine.eval_metrics_batch(episodes, w0=w0),
                           f"match eval batch of {E_MMN} ({name} route), torch.profiler", card,
                           groups=(("conv (backbone, rank-4 planes)", ("conv", "fprop")),
                                   ("gemm (correlation, readout)", ("gemm", "sgemm")),
                                   ("copies and permutes", ("copy", "permute")),
                                   ("reductions and argmax", ("reduce", "argmax", "max")),
                                   ("elementwise", ("elementwise", "vectorized"))))
    for name in ("flat", "6D"):
        agree = {k: float((preds[name][k].argmax(-1) == preds["rank-4"][k].argmax(-1))
                          .float().mean()) for k in ("pred", "pred1")}
        rel = {k: float((preds[name][k] - preds["rank-4"][k]).abs().max()
                        / preds["rank-4"][k].abs().max()) for k in ("pred", "pred1")}
        print(f"match {name} vs rank-4 route: argmax agreement {agree} (>= 0.995 needed), "
              f"max|p - p_r4| / max|p_r4| {rel}")
        if min(agree.values()) < 0.995:
            raise AssertionError(f"match {name} and rank-4 routes disagree: {agree}")
    del preds

    # ---- a train step of 2 on each route: gradients against rank-4 ----
    e2 = {k: v[:2] for k, v in episodes.items()}
    grads, train = {}, {}
    opt = torch.optim.SGD(engine.head.parameters(), lr=cfg.trans_lr)
    step = engine.make_train_step(opt)
    saved = {k: v.clone() for k, v in engine.head.state_dict().items()}
    for name in MATCH_ROUTES:
        with consensus_route(name):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_inner_loop.reset_launches()
            cuda_pivot.reset_launches()
            m = engine.backward_batch(e2, w0=w0[:2])
            torch.cuda.synchronize()
            counts = launch_counts(cuda_inner_loop, cuda_pivot)
            grads[name] = {k: p.grad.clone() for k, p in engine.head.named_parameters()}
            step_s = host_seconds(lambda: step(e2, w0=w0[:2]), 2)
            peak = peak_gib()
            engine.head.load_state_dict(saved)
        if not torch.isfinite(m["loss_mean"]):
            raise AssertionError(f"match train step ({name}): non-finite loss")
        pivots = counts["pivot_fwd"] + counts["pivot_dw"]
        if (name == "flat") != (min(counts["pivot_fwd"], counts["pivot_dw"]) > 0) \
                or (name != "flat" and pivots) or counts["adapt_binary"] < 1:
            raise AssertionError(f"match train step ({name}) launches {counts}")
        train[name] = dict(rate=2 / step_s, peak_gib=peak, launches=counts)
        print(f"match {name} route: train step of 2 (SGD) {2 / step_s:.3f} episodes/s "
              f"({step_s * 1e3:.1f} ms); peak memory {peak:.2f} GiB; launches (the gradients' "
              f"step) {counts} [{card}]")
    scale = {k: float(g.abs().max()) for k, g in grads["rank-4"].items()}
    if not all(np.isfinite(v) and v > 0 for v in scale.values()):
        raise AssertionError(f"match gradients: zero or non-finite tensor {scale}")
    for name in ("flat", "6D"):
        worst = max((float((grads[name][k] - g).abs().max()) / scale[k], k)
                    for k, g in grads["rank-4"].items())
        print(f"match train step gradients, {name} vs rank-4 route: worst max|g - g_r4| / "
              f"max|g_r4| = {worst[0]:.3e} ({worst[1]}); tolerance 1e-3")
        if not worst[0] <= 1e-3:
            raise AssertionError(f"match gradients differ, {name} vs rank-4: {worst}")
    del grads

    # ---- conv4d cv4: the true 4D conv's four routes ----
    cv4 = cv4_phase(cfg, backbone, calib_episodes, episodes, w0, card,
                    (HeadEngine, get_corr))
    return dict(ci1=ci1, eval_launches=launches["flat"], train_launches=train["flat"]["launches"],
                rates=rates, train=train, cv4=cv4)


def cv4_phase(cfg, backbone, calib_episodes, episodes, w0, card, modules):
    """The match head with ``conv4d cv4`` (1 -> 10 -> 10 -> 1 true 4D convs,
    symmetric, U(+-1/sqrt(fan_in)) weights and biases): one eval batch of 2
    and one train step of 2 on each ``FSS_CONV4D_IM2COL`` route, its biases
    calibrated as the centre-pivot stack's are. Predictions within 1e-4 of
    the q route's scale, gradients within 1e-3 of each tensor's largest
    entry; ms (eval after a warm-up call, the step's first call) and peak
    memory of each."""
    HeadEngine, get_corr = modules
    ccfg = cfg.clone()
    ccfg.conv4d = "cv4"
    engine = HeadEngine(ccfg, "match", backbone=backbone, device="cuda")
    calibrate_consensus(engine, calib_episodes, get_corr)
    e2 = {k: v[:2] for k, v in episodes.items()}
    out, ref = {}, None
    for route in CV4_ROUTES:
        with env_var("FSS_CONV4D_IM2COL", route):
            engine.predict_batch(e2, w0=w0[:2])            # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            p = engine.predict_batch(e2, w0=w0[:2])["pred1"]
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) * 1e3
            eval_peak = peak_gib()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = engine.backward_batch(e2, w0=w0[:2])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            step_peak = peak_gib()
        g = {k: q.grad.clone() for k, q in engine.head.named_parameters()}
        if not torch.isfinite(m["loss_mean"]) or not torch.isfinite(p).all():
            raise AssertionError(f"cv4 {route}: non-finite loss or prediction")
        if ref is None:
            ref = (p, g)
            p_err, g_err = 0.0, 0.0
        else:
            p_err = float((p - ref[0]).abs().max() / ref[0].abs().max())
            g_err = max(float((g[k] - r).abs().max() / r.abs().max()) for k, r in ref[1].items())
        out[route] = dict(eval_ms=eval_ms, eval_peak_gib=eval_peak, step_ms=step_ms,
                          step_peak_gib=step_peak, pred_rel=p_err, grad_rel=g_err)
        print(f"match conv4d cv4, FSS_CONV4D_IM2COL={route}: eval batch of 2 {eval_ms:.1f} ms "
              f"(peak {eval_peak:.2f} GiB), train step of 2 (gradients) {step_ms:.1f} ms "
              f"(peak {step_peak:.2f} GiB); max|p - p_q| / max|p_q| = {p_err:.3e} (tolerance "
              f"1e-4), worst gradient max|g - g_q| / max|g_q| = {g_err:.3e} (tolerance 1e-3) "
              f"[{card}]")
        if not (p_err <= 1e-4 and g_err <= 1e-3):
            raise AssertionError(f"cv4 route {route} disagrees with q: {out[route]}")
    if not all(float(r.abs().max()) > 0 for r in ref[1].values()):
        raise AssertionError("cv4: a head tensor has zero gradients")
    return out


def mmn_options_phase(engine, card, modules):
    """On the MMN engine of phase 6: one train step with ``meta_aug 2`` and
    ``att_type 3`` (two views a support, the better one read), counted; and
    eval of E_MMN with ``eval_episode_tile 2`` against the untiled run."""
    make_episode_batch, cuda_inner_loop, cuda_pivot = modules
    cfg = engine.cfg
    views = make_episode_batch(19, 2, size=IMG, shot=2)
    w0 = engine.init_weights(2, torch.Generator().manual_seed(8))
    shipped = cfg.meta_aug, cfg.att_type
    cfg.meta_aug, cfg.att_type = 2, 3
    try:
        with pivot_route(True):
            cuda_inner_loop.reset_launches()
            cuda_pivot.reset_launches()
            t0 = time.perf_counter()
            m = engine.backward_batch(views, w0=w0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts = launch_counts(cuda_inner_loop, cuda_pivot)
    finally:
        cfg.meta_aug, cfg.att_type = shipped
    print(f"MMN meta_aug 2, att_type 3 (flat route): train step gradients of 2 episodes x 2 "
          f"views in {ms:.1f} ms, loss {float(m['loss_mean']):.4f}; launches {counts} [{card}]")
    if not torch.isfinite(m["loss_mean"]) or counts["pivot_dw"] < 1:
        raise AssertionError(f"MMN meta_aug step: {m['loss_mean']}, {counts}")

    episodes = make_episode_batch(13, E_MMN, size=IMG, shot=SHOT)
    w0 = engine.init_weights(E_MMN, torch.Generator().manual_seed(5))
    out = {}
    with pivot_route(True):
        for tile in (1, 2):
            cfg.eval_episode_tile = tile
            out[tile] = engine.eval_metrics_batch(episodes, w0=w0)
            out[f"masks{tile}"] = engine.serve_batch(episodes, w0=w0)
            out[f"s{tile}"] = host_seconds(lambda: engine.eval_metrics_batch(episodes, w0=w0), 2)
    cfg.eval_episode_tile = 1
    differ = int((out["masks1"] != out["masks2"]).sum())
    same_iou = all(torch.equal(out[1][k], out[2][k]) for k in ("inter", "union", "inter1",
                                                               "union1"))
    print(f"MMN eval_episode_tile 2 vs 1 (flat route, {E_MMN} episodes): {differ} of "
          f"{out['masks1'].numel()} mask pixels differ, I/U equal {same_iou}; eval "
          f"{E_MMN / out['s2']:.3f} vs {E_MMN / out['s1']:.3f} episodes/s [{card}]")
    if differ or not same_iou:
        raise AssertionError("eval_episode_tile 2 changed the MMN eval masks")


def k2_phase(cuda_inner_loop, pick_tile, cuda_ms, inputs, acc_k1, acc_plain, tol, card):
    """K2 at tile 2 on the K1 phase's inputs (E = 8, 200 steps): against the
    plain version and against K1 with K1's tolerance (it gives K1's bits),
    its time, and its shared memory from the library against the formula."""
    f_s, pw, pwy, u0 = inputs
    acc = cuda_inner_loop.adapt_binary_tiled(f_s, pw, pwy, u0, STEPS, CLS_LR, TILE)
    torch.cuda.synchronize()
    err = float((acc - acc_plain).abs().max())
    vs_k1 = float((acc - acc_k1).abs().max())
    lib = cuda_inner_loop.load_library()
    plan = cuda_inner_loop.LAST_PLAN["adapt_binary_tiled"]
    smem = lib.fss_adapt_binary_smem_bytes(FEAT, FEAT, CH, IMG, IMG, SHOT, TILE, plan.rows,
                                           plan.pin)
    formula = cuda_inner_loop.smem_bytes(FEAT, FEAT, CH, IMG, TILE, big_h=IMG, rows=plan.rows,
                                         pin=plan.pin)
    tiles = {}
    for want in ("2", "4"):
        with env_var("FSS_INNER_TILE", want):
            tiles[want] = pick_tile(E, SHOT, FEAT, FEAT, CH, IMG)
    print(f"K2 adapt_binary_tiled (tile {TILE}): max|acc_k2 - acc_p| = {err:.3e}, "
          f"max|acc_k2 - acc_k1| = {vs_k1:.3e} (tolerance 1e-4 * max|acc_p| = {tol:.3e}; "
          f"equal bits: {bool(torch.equal(acc, acc_k1))}); plan {json.dumps(plan.summary())}; "
          f"shared memory {smem} B per CTA (formula {formula}; least layout at tile 4 "
          f"{cuda_inner_loop.smem_bytes(FEAT, FEAT, CH, IMG, 4)} of "
          f"{cuda_inner_loop.MAX_SMEM_BYTES}); pick_tile at E = {E}, 473 px for "
          f"FSS_INNER_TILE 2 / 4: {tiles['2']} / {tiles['4']}")
    if not np.isfinite(err) or err > tol or vs_k1 > tol:
        raise AssertionError(f"K2 disagrees with the plain version or K1: {err}, {vs_k1}")
    if smem != formula or smem != plan.smem or tiles != {"2": 2, "4": 4}:
        raise AssertionError(f"K2's shared memory or the tile dispatch: {smem}, {formula}, "
                             f"{tiles}")
    k2_t = launch_and_op_ms(
        lambda: cuda_inner_loop.launch(lib, f_s, pw, pwy, u0, STEPS, CLS_LR, TILE),
        lambda: cuda_inner_loop.adapt_binary_tiled(f_s, pw, pwy, u0, STEPS, CLS_LR, TILE))
    print(f"K2 adapt_binary_tiled (tile {TILE}): {dispatch_text(k2_t)} [{card}]")
    return err, k2_t


def cwt_train_phase(engine, episodes, w0, card, modules):
    """The CWT meta-train step at full width: gradients on the K1 path, the
    K2 path and the plain inner loop (dropout off), held against each other;
    launch counts around each kernel path; timed SGD steps with dropout on at
    both tiles and a profiler breakdown of each. Returns the launch counts of
    the K1 and K2 paths."""
    cuda_inner_loop, binary_pixel_weights, build_optimizer = modules
    cfg = engine.cfg
    batch = engine.to_device(episodes)
    cwt = engine.cwt
    rates = (cfg.dropout, cwt.dropout, cwt.attn_dropout)

    # ---- one step's gradients, dropout off, three inner loops ----
    cfg.dropout = cwt.dropout = cwt.attn_dropout = 0.0
    grads, counts, losses = {}, {}, {}
    for name, tile in (("K1", None), ("K2", TILE)):
        with inner_tile(tile):
            cwt.zero_grad(set_to_none=True)
            cuda_inner_loop.reset_launches()
            loss, _ = engine.train_episode_losses(episodes, w0=w0, with_metrics=False)
            loss.mean().backward()
            torch.cuda.synchronize()
            counts[name] = dict(cuda_inner_loop.LAUNCHES)
        grads[name] = {k: p.grad.clone() for k, p in cwt.named_parameters()}
        losses[name] = loss.detach()
    with torch.no_grad():
        f_s, f_q = engine._episode_features(batch)
        pw, pwy = binary_pixel_weights(batch["s_label"])
        acc = cuda_inner_loop.adapt_binary_reference(
            f_s, pw, pwy, (w0[:, 1] - w0[:, 0]).contiguous(), STEPS, CLS_LR)
        w_plain = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
    cwt.zero_grad(set_to_none=True)
    loss, _ = engine._train_losses(f_q, w_plain, batch["q_label"], with_metrics=False)
    loss.mean().backward()
    grads["plain"] = {k: p.grad.clone() for k, p in cwt.named_parameters()}
    losses["plain"] = loss.detach()
    cfg.dropout, cwt.dropout, cwt.attn_dropout = rates
    cwt.zero_grad(set_to_none=True)

    print(f"CWT train step launches: K1 path {counts['K1']}; K2 path (FSS_INNER_TILE={TILE}) "
          f"{counts['K2']}")
    if counts["K1"]["adapt_binary"] < 1 or counts["K1"]["adapt_binary_tiled"] != 0:
        raise AssertionError(f"the K1 path of the train step: {counts['K1']}")
    if counts["K2"]["adapt_binary_tiled"] < 1 or counts["K2"]["adapt_binary"] != 0:
        raise AssertionError(f"the K2 path of the train step: {counts['K2']}")
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    rel = {}
    for a, b in (("K2", "K1"), ("K1", "plain"), ("K2", "plain")):
        for k, g in grads[b].items():
            diff = float((grads[a][k] - g).abs().max())
            rel[f"{a} vs {b}: {k}"] = diff / max(float(g.abs().max()), 1e-30)
            if not diff <= 1e-3 * float(g.abs().max()) + 1e-7 * top:
                raise AssertionError(f"CWT gradients {a} vs {b} differ in {k}: {diff}")
    loss_rel = {f"{a} vs {b}": float(((losses[a] - losses[b]).abs()
                                      / losses[b].abs()).max())
                for a, b in (("K2", "K1"), ("K1", "plain"))}
    print(f"CWT train-step gradients (dropout off), max|g_a - g_b| / max|g_b| per tensor "
          f"(tolerance 1e-3, plus 1e-7 of the largest entry for the layer_norm.bias "
          f"gradient, 0 in exact arithmetic): {json.dumps(rel)}; per-episode losses, "
          f"max relative difference {loss_rel}; per-episode losses (plain) "
          f"{np.round(losses['plain'].cpu().numpy(), 4).tolist()}; max|g| per tensor "
          f"{ {k: float(g.abs().max()) for k, g in grads['plain'].items()} }")

    # ---- timed SGD steps with dropout on, both tiles ----
    start = {k: v.clone() for k, v in cwt.state_dict().items()}
    rows = {}
    for name, tile in (("K1", None), ("K2", TILE)):
        cwt.load_state_dict(start)
        opt, _ = build_optimizer(cwt.parameters(), cfg, base_lr=cfg.trans_lr * cfg.scale_lr,
                                 use_schedule=False)
        step = engine.make_train_step(opt, with_metrics=False)
        gen = torch.Generator().manual_seed(300)
        with inner_tile(tile):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step_losses, times = [], []
            for _ in range(4):
                t0 = time.perf_counter()
                m = step(episodes, gen, w0=w0)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                step_losses.append(float(m["loss"]))
            peak = torch.cuda.max_memory_allocated() / 2**30
            step_s = statistics.median(times[1:])
            print(f"CWT train step ({name} path, dropout on, SGD lr "
                  f"{cfg.trans_lr * cfg.scale_lr}, loss-only step): {E / step_s:.3f} episodes/s "
                  f"({step_s * 1e3:.1f} ms per step of {E}; steps "
                  f"{np.round(times, 4).tolist()} s); losses over the steps on one batch "
                  f"{np.round(step_losses, 4).tolist()}; peak memory {peak:.2f} GiB [{card}; "
                  f"fp32, TF32 off, 1-shot, 473 px, adapt_iter {STEPS}]")
            if not all(np.isfinite(step_losses)):
                raise AssertionError(f"CWT train steps ({name}): non-finite loss {step_losses}")
            device_profile(lambda: step(episodes, gen, w0=w0),
                           f"CWT train step of {E} ({name} path), torch.profiler", card)
        rows[name] = step_s
    cwt.load_state_dict(start)
    return counts, rows



def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def padded_episodes(seed, e, shot):
    """``e`` synthetic episodes at 473 px; episode 0's last shot is an
    all-255 pad, the ``random_shot`` form."""
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    episodes = make_episode_batch(seed, e, size=IMG, shot=shot)
    episodes["s_label"][0, shot - 1] = 255
    return episodes


def k1_shot5_phase(cuda_inner_loop, binary_pixel_weights, cuda_ms, rng, card):
    """K1 at E = 8 and shot 5, 200 steps (episode 0 with a padded shot),
    against the plain loop with K1's tolerance, timed beside its bound; the
    work plan it launched (CTAs an episode, how much of f it keeps in shared
    memory: ``inner_loop_plan.smem_bytes`` counts ``shot`` chains a CTA)."""
    dev = torch.device("cuda")
    f_s = torch.tensor(np.abs(rng.standard_normal((E, SHOT5, FEAT, FEAT, CH)))
                       .astype(np.float32), device=dev)
    s_label = torch.tensor(padded_episodes(23, E, SHOT5)["s_label"], device=dev).long()
    pw, pwy = binary_pixel_weights(s_label)
    u0 = torch.tensor((rng.uniform(-2, 2, (E, CH)) / np.sqrt(CH)).astype(np.float32),
                      device=dev)
    acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, STEPS, CLS_LR)
    plan = cuda_inner_loop.LAST_PLAN["adapt_binary"]
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS, CLS_LR)
    torch.cuda.synchronize()
    err, tol = float((acc_k - acc_p).abs().max()), 1e-4 * float(acc_p.abs().max())
    ms = cuda_ms(lambda: cuda_inner_loop.launch(cuda_inner_loop.load_library(), f_s, pw, pwy,
                                                u0, STEPS, CLS_LR), 5)
    plain_ms = cuda_ms(lambda: cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS,
                                                                      CLS_LR), 3)
    flops, nbytes = inner_loop_work(E, SHOT5, FEAT, FEAT, CH, IMG, IMG, STEPS)
    b_ms, b_by = bound(flops, nbytes)
    f_rows = plan.rows * FEAT
    print(f"K1 adapt_binary at E = {E}, shot {SHOT5}: max|acc_k - acc_p| = {err:.3e} "
          f"(tolerance 1e-4 * max|acc_p| = {tol:.3e}); kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB); {plan.ctas_per_group} CTAs an episode, grid {plan.grid}, "
          f"f pinned in shared memory for {plan.pin} of each chain's {f_rows} slice pixels "
          f"({SHOT5} chains a CTA); plan {json.dumps(plan.summary())}; library_ms null [{card}]")
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"K1 at shot {SHOT5} disagrees with its plain version: {err} > {tol}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def cwt_shot5_phase(engine, card, modules):
    """CWT eval and serve of 8 episodes at shot 5 (one padded shot) on the
    calibrated engine's modules, counted; masks against the plain inner
    loop; then the train step of 8 at shot 5 with FSS_INNER_TILE unset and
    at 2 (K2 is 1-shot only, as in the JAX package: both run K1), its
    gradients against the plain loop's, and timed SGD steps."""
    (EpisodicEngine, cuda_inner_loop, binary_pixel_weights, build_optimizer) = modules
    cfg = engine.cfg.clone()
    cfg.shot = SHOT5
    eng = EpisodicEngine(cfg, backbone=engine.backbone, cwt=engine.cwt, device="cuda")
    episodes = padded_episodes(29, E, SHOT5)
    w0 = eng.init_weights(E, torch.Generator().manual_seed(31))
    batch = eng.to_device(episodes)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_inner_loop.reset_launches()
    masks = eng.serve_batch(episodes, w0=w0)
    metrics = eng.eval_metrics_batch(episodes, w0=w0)
    torch.cuda.synchronize()
    launches = dict(cuda_inner_loop.LAUNCHES)
    plan = cuda_inner_loop.LAST_PLAN["adapt_binary"]
    peak = peak_gib()
    if launches["adapt_binary"] < 1 or plan is None or plan.shot != SHOT5:
        raise AssertionError(f"CWT {SHOT5}-shot eval/serve did not launch K1 at shot "
                             f"{SHOT5}: {launches}")
    for k in ("inter", "union", "inter0", "union0", "loss", "loss0"):
        if not torch.isfinite(metrics[k]).all():
            raise AssertionError(f"CWT {SHOT5}-shot eval: non-finite {k}")
    with torch.no_grad():
        f_s, f_q = eng._episode_features(batch)
        pw, pwy = binary_pixel_weights(batch["s_label"])
        acc = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy,
                                                     (w0[:, 1] - w0[:, 0]).contiguous(),
                                                     STEPS, CLS_LR)
        w_plain = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
        masks_plain = eng.mask_from_prediction(eng._predict(f_q, w_plain)[0], (IMG, IMG))
    agree = float((masks == masks_plain).float().mean())
    serve_s = host_seconds(lambda: eng.serve_batch(episodes, w0=w0), 3)
    eval_s = host_seconds(lambda: eng.eval_metrics_batch(episodes, w0=w0), 3)
    print(f"CWT {SHOT5}-shot (episode 0 with a padded shot) eval + serve of {E} launches "
          f"{launches}, K1 plan {plan.ctas_per_group} CTAs an episode; kernel vs plain inner "
          f"loop mask agreement {agree:.6f} (>= 0.995 needed); serve_batch "
          f"{E / serve_s:.3f} episodes/s ({serve_s * 1e3:.1f} ms), eval_metrics_batch "
          f"{E / eval_s:.3f} episodes/s ({eval_s * 1e3:.1f} ms); peak memory {peak:.2f} GiB "
          f"[{card}; fp32, TF32 off, 473 px, adapt_iter {STEPS}]")
    if agree < 0.995:
        raise AssertionError(f"CWT {SHOT5}-shot: kernel and plain masks agree on {agree}")

    # ---- the train step at shot 5, both tile settings ----
    cwt = eng.cwt
    rates = (cfg.dropout, cwt.dropout, cwt.attn_dropout)
    cfg.dropout = cwt.dropout = cwt.attn_dropout = 0.0
    grads, counts = {}, {}
    for name, tile in (("tile unset", None), ("FSS_INNER_TILE=2", TILE)):
        with inner_tile(tile):
            cwt.zero_grad(set_to_none=True)
            cuda_inner_loop.reset_launches()
            loss, _ = eng.train_episode_losses(episodes, w0=w0, with_metrics=False)
            loss.mean().backward()
            torch.cuda.synchronize()
            counts[name] = dict(cuda_inner_loop.LAUNCHES)
        grads[name] = {k: p.grad.clone() for k, p in cwt.named_parameters()}
    cwt.zero_grad(set_to_none=True)
    loss, _ = eng._train_losses(f_q, w_plain, batch["q_label"], with_metrics=False)
    loss.mean().backward()
    grads["plain"] = {k: p.grad.clone() for k, p in cwt.named_parameters()}
    cfg.dropout, cwt.dropout, cwt.attn_dropout = rates
    cwt.zero_grad(set_to_none=True)
    print(f"CWT {SHOT5}-shot train step launches: {counts}")
    for name, c in counts.items():
        if c["adapt_binary"] < 1 or c["adapt_binary_tiled"] != 0:
            raise AssertionError(f"CWT {SHOT5}-shot train step ({name}): {c}")
    top = max(float(g.abs().max()) for g in grads["plain"].values())
    for a in ("tile unset", "FSS_INNER_TILE=2"):
        for k, g in grads["plain"].items():
            diff = float((grads[a][k] - g).abs().max())
            if not diff <= 1e-3 * float(g.abs().max()) + 1e-7 * top:
                raise AssertionError(f"CWT {SHOT5}-shot gradients ({a}) vs plain differ in {k}: "
                                     f"{diff}")
    start = {k: v.clone() for k, v in cwt.state_dict().items()}
    opt, _ = build_optimizer(cwt.parameters(), cfg, base_lr=cfg.trans_lr * cfg.scale_lr,
                             use_schedule=False)
    step = eng.make_train_step(opt, with_metrics=False)
    gen = torch.Generator().manual_seed(301)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        m = step(episodes, gen, w0=w0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    step_s = statistics.median(times[1:])
    cwt.load_state_dict(start)
    print(f"CWT {SHOT5}-shot train step (K1, dropout on, SGD, loss-only; gradients within "
          f"1e-3 of the plain loop's on both tile settings): {E / step_s:.3f} episodes/s "
          f"({step_s * 1e3:.1f} ms per step of {E}); losses {np.round(losses, 4).tolist()}; "
          f"peak memory {peak_gib():.2f} GiB [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"CWT {SHOT5}-shot train steps: non-finite loss {losses}")
    return launches["adapt_binary"] + sum(c["adapt_binary"] for c in counts.values())


def bf16_serve_phase(engine, episodes, w0, masks32, card, modules):
    """CWT serve of 8 at 1-shot under ``compute_dtype bfloat16`` and under
    ``bf16_stages stem,layer1,layer2``, each on a copy of the calibrated
    fp32 backbone: counted (K1 runs on fp32 features), masks against the
    fp32 engine's, episodes/s, the backbone's time and peak memory."""
    import copy

    EpisodicEngine, cuda_inner_loop, cuda_ms = modules
    batch = engine.to_device(episodes)
    with torch.no_grad():
        base_ms = cuda_ms(lambda: engine._episode_features(batch), 3)
    for name, opts in (("compute_dtype bfloat16", {"compute_dtype": "bfloat16"}),
                       (f"bf16_stages {MIXED}", {"bf16_stages": MIXED})):
        cfg = engine.cfg.clone()
        cfg.update(opts)
        eng = EpisodicEngine(cfg, backbone=copy.deepcopy(engine.backbone), cwt=engine.cwt,
                             device="cuda")
        dtypes = {st: str(next(m.parameters()).dtype).split(".")[-1]
                  for st, m in eng.backbone.stage_modules().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_inner_loop.reset_launches()
        masks = eng.serve_batch(episodes, w0=w0)
        torch.cuda.synchronize()
        launches = dict(cuda_inner_loop.LAUNCHES)
        peak = peak_gib()
        if launches["adapt_binary"] < 1:
            raise AssertionError(f"CWT serve ({name}) did not launch K1: {launches}")
        with torch.no_grad():
            f_s, f_q = eng._episode_features(batch)
            if f_s.dtype != torch.float32 or f_q.dtype != torch.float32:
                raise AssertionError(f"{name}: features reach the inner loop as {f_s.dtype}")
            feat_ms = cuda_ms(lambda: eng._episode_features(batch), 3)
        agree = float((masks == masks32).float().mean())
        serve_s = host_seconds(lambda: eng.serve_batch(episodes, w0=w0), 3)
        print(f"CWT serve_batch of {E}, {name} (stage dtypes {dtypes}): {E / serve_s:.3f} "
              f"episodes/s ({serve_s * 1e3:.1f} ms per batch); backbone {feat_ms:.1f} ms "
              f"(fp32 {base_ms:.1f} ms); launches {launches}; masks equal to the fp32 "
              f"engine's on {agree:.4%} of pixels; peak memory {peak:.2f} GiB [{card}; "
              f"1-shot, 473 px, adapt_iter {STEPS}]")
        if tuple(masks.shape) != (E, IMG, IMG) or not set(masks.unique().tolist()) <= {0, 1}:
            raise AssertionError(f"{name}: masks {tuple(masks.shape)}")
        del eng
        torch.cuda.empty_cache()


def ab_dtype_phase(engine, card):
    """``eval.ab_dtype.run_ab`` over 16 episodes on the calibrated CWT
    backbone (saved as a stage-1 .pth and loaded through ``--pth``)."""
    from few_shot_seg_cwt_tpu_torch.eval import ab_dtype

    os.makedirs("build", exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_ab_", suffix=".pth", dir="build")
    os.close(fd)
    try:
        torch.save({k: v.cpu() for k, v in engine.backbone.state_dict().items()}, path)
        res = ab_dtype.run_ab(engine.cfg.clone(), 16, E, pth=path, device="cuda",
                              log=lambda *a: None)
    finally:
        os.remove(path)
    print(f"eval.ab_dtype (16 episodes, batches of {E}, calibrated backbone, random CWT): "
          f"mIoU fp32 {res['miou_fp32']:.4f} / bf16 {res['miou_bf16']:.4f} (delta "
          f"{res['delta_pts']:.3f} points), raw classifier {res['miou_raw_fp32']:.4f} / "
          f"{res['miou_raw_bf16']:.4f}; mask agreement {res['mask_agreement']:.4%} "
          f"[{card}]: {json.dumps(res)}")
    if not (np.isfinite(res["delta_pts"]) and 0.0 <= res["mask_agreement"] <= 1.0):
        raise AssertionError(f"ab_dtype: {res}")


def mmn_shot5_phase(engine, card, modules):
    """The MMN train step of 2 at shot 5 (episode 0 with a padded shot), the
    config as shipped (``use_amp True``), flat route, counted: the defaults
    (``shot_remat``, ``shot_hoist_query``, ``shot_tile 1``), then
    ``shot_tile 5`` and ``shot_native`` where the defaults' peak memory
    leaves room for five shots' activations."""
    HeadEngine, cuda_inner_loop, cuda_pivot, build_optimizer = modules
    cfg = engine.cfg.clone()
    cfg.shot = SHOT5
    eng = HeadEngine(cfg, "mmn", backbone=engine.backbone, head=engine.head, device="cuda")
    e2 = padded_episodes(37, 2, SHOT5)
    start = {k: v.clone() for k, v in eng.head.state_dict().items()}
    peaks = {}
    for name, opts in (("defaults", {}), ("shot_tile 5", {"shot_tile": 5}),
                       ("shot_native", {"shot_native": True})):
        if name != "defaults" and 5 * peaks["defaults"] > 70:
            print(f"MMN {SHOT5}-shot train step, {name}: not run (five times the defaults' "
                  f"peak, {5 * peaks['defaults']:.1f} GiB, exceeds 70 GiB)")
            continue
        for k, v in (("shot_tile", 1), ("shot_native", False)):
            eng.cfg[k] = v
        eng.cfg.update(opts)
        eng.head.load_state_dict(start)
        opt, sched = build_optimizer(eng.head.parameters(), cfg,
                                     base_lr=cfg.trans_lr * cfg.scale_lr,
                                     iters_per_epoch=max(1, cfg.iter_per_epoch // 2))
        step = eng.make_train_step(opt, sched)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        with pivot_route(True):
            cuda_inner_loop.reset_launches()
            cuda_pivot.reset_launches()
            for i in range(3):
                t0 = time.perf_counter()
                m = step(e2, torch.Generator().manual_seed(400 + i))
                losses.append(float(m["loss_mean"]))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            launches = launch_counts(cuda_inner_loop, cuda_pivot)
        peaks[name] = peak_gib()
        step_s = statistics.median(times[1:])
        print(f"MMN {SHOT5}-shot train step of 2, {name} (use_amp, flat route, dropout on, "
              f"SGD): {2 / step_s:.3f} episodes/s ({step_s * 1e3:.1f} ms per step; steps "
              f"{np.round(times, 3).tolist()} s); losses {np.round(losses, 4).tolist()}; "
              f"launches {launches}; peak memory {peaks[name]:.2f} GiB [{card}]")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"MMN {SHOT5}-shot ({name}): non-finite loss {losses}")
        if min(launches[k] for k in ("adapt_binary", "pivot_fwd", "pivot_dw")) < 1:
            raise AssertionError(f"MMN {SHOT5}-shot ({name}) did not launch every kernel: "
                                 f"{launches}")
    eng.head.load_state_dict(start)


def log_txt_val(directory, prefix):
    """The lines of ``<directory>/log.txt`` that start with ``prefix``; fails
    without the file or such a line."""
    path = os.path.join(directory, "log.txt")
    if not os.path.isfile(path):
        raise AssertionError(f"no log.txt in {directory}")
    with open(path) as f:
        val = [l.rstrip("\n") for l in f if l.startswith(prefix)]
    if not val:
        raise AssertionError(f"{path} holds no '{prefix}' line")
    return val


def train_cwt_entry_phase(load_cfg, merge_cfg_from_list, train_cwt, test_entry,
                          trans_ckpt_dir):
    """``train.train_cwt.main``: one epoch with checkpoints, a resume from its
    train state for one more, and ``train.test.main`` loading its best.pth."""
    os.makedirs("build", exist_ok=True)
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir="build")
    try:
        def cfg(*opts):
            return merge_cfg_from_list(load_cfg("configs/pascal.yaml"), [
                "synthetic_data", "True", "iter_per_epoch", str(2 * E), "episode_batch",
                str(E), "test_num", "8", "n_runs", "1", "save_models", "True",
                "model_dir", model_dir, *opts])

        keep = ("Epoch ", "Saving checkpoint", "=> resumed", "mIoU---Val", "=> Max_mIoU",
                "=> stop_after", "=> loading transformer")
        lines = []
        best = train_cwt.main(cfg("epochs", "1"), device="cuda", log=lines.append)
        out = trans_ckpt_dir(cfg())
        written = sorted(os.listdir(out))
        state = os.path.join(out, "train_state.pth")
        lines.append(f"checkpoints written: {written}")
        best2 = train_cwt.main(cfg("epochs", "2", "resume_ckpt", state, "stop_after_epochs", "1"),
                               device="cuda", log=lines.append)
        miou = test_entry.main(cfg("ckpt_used", "best"), device="cuda", log=lines.append)
        print("train.train_cwt.main (2 steps of 8 an epoch, test_num 8, random init, synthetic "
              "episodes): " + " | ".join(str(l) for l in lines
                                        if str(l).startswith(keep + ("checkpoints",))))
        print(f"train.train_cwt.main: best mIoU {best:.4f} after epoch 1, {best2:.4f} after "
              f"the resumed epoch 2; train.test.main on best.pth: mIoU {miou:.4f}")
        with open(os.path.join(out, "log.txt")) as f:
            logged = f.read().splitlines()
        val = [l for l in logged if l.startswith("mIoU---Val result")]
        print(f"train.train_cwt.main log.txt: {len(logged)} lines, val lines {val}")
        if written != ["best.pth", "final.pth", "log.txt", "train_state.pth"] or not val:
            raise AssertionError(f"train_cwt wrote {written}, val lines in log.txt {val}")
        if not any(str(l).startswith("=> resumed full train state at epoch 1") for l in lines):
            raise AssertionError("train_cwt did not resume its train state")
        if not any(str(l).startswith("=> loading transformer weight") for l in lines):
            raise AssertionError("train.test.main did not load best.pth")
        if not all(np.isfinite([best, best2, miou])):
            raise AssertionError("train_cwt / test returned a non-finite mIoU")
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)


# ---- the real-data phase: a PASCAL-layout tree written here ----

VOC_SIZES = ((375, 500), (500, 375), (333, 500))  # (H, W) of VOC2012 images
N_TREE = 48                                       # images: 32 train, 16 val
FEED_BATCHES = 8                                  # batches a feed timing
FEED_COPIES = 4                                   # the feed list: the tree 4 times


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit gray (H, W) or RGB (H, W, 3) PNG, written with zlib alone.
    Row y is filtered with PNG filter type y % 5 (None, Sub, Up, Average,
    Paeth), so the decoder's five unfilters all run."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else 3
    raw = arr.reshape(h, w * bpp).astype(np.int64)
    up = np.vstack([np.zeros((1, w * bpp), np.int64), raw[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), raw[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int64), up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) // 2, paeth])
    kinds = np.arange(h) % 5
    rows = ((raw - preds[kinds, np.arange(h)]) % 256).astype(np.uint8)
    body = np.hstack([kinds[:, None].astype(np.uint8), rows]).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, 0 if bpp == 1 else 2, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))


def write_voc_tree(root: str) -> dict:
    """48 PNG images at VOC sizes with gray PNG masks (SegmentationClassAug
    layout): 1-3 objects each, an ellipse of a split-0 val class (1-5), one of
    a train class (6-20) and on every third image a second train class, each
    at least 2048 px and ringed by 5 px of 255. Images 0-31 are listed in
    train.txt, 32-47 in val.txt, and all 48 four times over in feed.txt
    (every image holds a val class). Returns {image index: classes
    present}."""
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "SegmentationClassAug"))
    rng = np.random.default_rng(10)
    palette = np.random.default_rng(20).uniform(30, 225, (21, 3))
    present = {}
    lines = {"train": [], "val": []}
    for i in range(N_TREE):
        h, w = VOC_SIZES[i % len(VOC_SIZES)]
        yy, xx = np.mgrid[0:h, 0:w]
        lab = np.zeros((h, w), np.uint8)
        classes = [1 + i % 5, 6 + i % 15] + ([6 + (i * 7 + 3) % 15] if i % 3 == 0 else [])
        classes = list(dict.fromkeys(classes))
        for k, c in enumerate(classes):
            cy, cx = (h * (0.3 + 0.4 * (k % 2)), w * (0.25 + 0.25 * k))
            ry, rx = h * rng.uniform(0.12, 0.2), w * rng.uniform(0.08, 0.11)
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            ring = ((yy - cy) / (ry + 5)) ** 2 + ((xx - cx) / (rx + 5)) ** 2
            lab[(ring < 1) & (lab == 0)] = 255
            lab[d < 1] = c
        img = rng.normal(110, 25, (h, w, 3))
        for c in classes:
            img[lab == c] += palette[c] - 110
        img = np.clip(img, 0, 255).astype(np.uint8)
        for c in classes:
            if int((lab == c).sum()) < 2048:
                raise AssertionError(f"tree image {i}: class {c} under 2048 px")
        present[i] = classes
        name = f"2008_{i:06d}"
        with open(os.path.join(root, "JPEGImages", name + ".png"), "wb") as f:
            f.write(png_bytes(img))
        with open(os.path.join(root, "SegmentationClassAug", name + ".png"), "wb") as f:
            f.write(png_bytes(lab))
        lines["train" if i < 32 else "val"].append(
            f"JPEGImages/{name}.png SegmentationClassAug/{name}.png\n")
    lines["feed"] = (lines["train"] + lines["val"]) * FEED_COPIES
    for split, ls in lines.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.writelines(ls)
    return present


def write_episode_log(path: str, present: dict) -> None:
    """32 val episodes: 0-15 of classes 1 and 2, 16-31 of classes 3, 4 and 5,
    each a query and one support (another val image holding the class)."""
    rng = np.random.default_rng(30)
    val = [i for i in present if i >= 32]
    pair = lambda i: [f"JPEGImages/2008_{i:06d}.png",  # noqa: E731
                      f"SegmentationClassAug/2008_{i:06d}.png"]
    with open(path, "w") as f:
        for e in range(32):
            cls = (1, 2)[e % 2] if e < 16 else (3, 4, 5)[e % 3]
            holders = [i for i in val if cls in present[i]]
            q, s = rng.choice(holders, size=2, replace=False)
            f.write(json.dumps({"q": pair(int(q)), "cls": cls, "s": [pair(int(s))]}) + "\n")


@contextlib.contextmanager
def without_cv2_and_pil():
    """Import of cv2 and PIL fails inside the block, as on a machine that has
    neither."""
    saved = {m: sys.modules.get(m) for m in ("cv2", "PIL")}
    for m in saved:
        sys.modules[m] = None
    try:
        yield
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def class_lines(lines):
    """Per run, [Class lines] of a validate_transformer log."""
    runs = []
    for line in map(str, lines):
        if line.startswith("mIoU---Val result"):
            runs.append([])
        elif line.startswith("Class ") and runs:
            runs[-1].append(line)
    return runs


def loader_alone(loader) -> float:
    """Episodes/s of ``loader`` with no consumer (its first batch, the
    pipeline's start, untimed)."""
    from few_shot_seg_cwt_tpu_torch.data.loader import infinite

    stream = infinite(loader)
    next(stream)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FEED_BATCHES):
        next(stream)
    torch.cuda.synchronize()
    return FEED_BATCHES * E / (time.perf_counter() - t0)


def feed_timings(cfg, dtype, card):
    """The loader against episodes already on the card, for one backbone
    dtype, on the feed list (one pass of 24 batches outlasts each timed
    window, so a pass's cold start is not timed): episodes/s of eval fed by
    the loader (4 decode threads, pinned ring) and of the same batches
    pre-collated on the card, the host's wait per batch, the loader's own
    rate with no consumer at 4 and 8 decode threads and in the consumer's
    thread, the PNG decode's share of one thread's work, and one batch's
    copy to the card from pinned and from pageable memory."""
    from few_shot_seg_cwt_tpu_torch.data import imread
    from few_shot_seg_cwt_tpu_torch.data.loader import infinite
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop import cuda_ms
    from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader

    cfg = cfg.clone()
    cfg.compute_dtype = dtype
    engine = EpisodicEngine(cfg, device="cuda")
    w0 = engine.init_weights(E, torch.Generator().manual_seed(4))
    loader = episodic_val_loader(cfg, device="cuda")
    alone = loader_alone(loader)
    threads = {}
    for workers in (0, 8):
        one = cfg.clone()
        one.workers = workers
        threads[workers] = loader_alone(episodic_val_loader(one, device="cuda"))
    alone8 = threads[8]

    # the loader feeding eval batches
    stream = infinite(loader)
    engine.eval_metrics_batch(next(stream), w0=w0)["loss"].cpu()  # warm-up
    kept, waits = [], []
    t0 = time.perf_counter()
    for _ in range(FEED_BATCHES):
        tw = time.perf_counter()
        batch = next(stream)
        waits.append(time.perf_counter() - tw)
        engine.eval_metrics_batch(batch, w0=w0)["loss"].cpu()
        kept.append({k: v.clone() for k, v in batch.items()})
    fed = FEED_BATCHES * E / (time.perf_counter() - t0)
    del stream

    # the same batches already on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in kept:
        engine.eval_metrics_batch(batch, w0=w0)["loss"].cpu()
    in_memory = FEED_BATCHES * E / (time.perf_counter() - t0)

    # one batch's copy to the card, pinned against pageable
    host = {k: v.cpu() for k, v in kept[0].items()}
    pinned = {k: v.pin_memory() for k, v in host.items()}
    nbytes = sum(v.numel() * v.element_size() for v in host.values())

    def h2d(src):
        return lambda: [v.to("cuda", non_blocking=True) for v in src.values()]

    pinned_ms, pageable_ms = cuda_ms(h2d(pinned), 10), cuda_ms(h2d(host), 10)
    label_bytes = sum(host[k].numel() for k in ("q_label", "s_label")) * 4
    # the decode's share of one thread's work: the episode's four files
    # (two images, two masks) against the whole sample
    files = [p for item in loader.dataset.data_list[:16] for p in item]
    t0 = time.perf_counter()
    for i, path in enumerate(files):
        imread.read(path, gray=i % 2 == 1)
    decode_ms = 4 * 1e3 * (time.perf_counter() - t0) / len(files)
    row = dict(dtype=dtype, fed=fed, in_memory=in_memory, alone=alone, alone8=alone8,
               alone0=threads[0], decode_ms=decode_ms,
               wait_ms=1e3 * statistics.mean(waits), wait_max_ms=1e3 * max(waits),
               pinned_ms=pinned_ms, pageable_ms=pageable_ms, batch_mb=nbytes / 1e6)
    print(f"feed ({dtype} backbone, batches of {E} at {cfg.image_size} px, "
          f"{FEED_BATCHES} batches, 4 decode threads): loader-fed eval {fed:.3f} episodes/s "
          f"against {in_memory:.3f} on the same batches pre-collated on the card; host wait "
          f"per batch {row['wait_ms']:.2f} ms (max {row['wait_max_ms']:.2f}); the loader alone "
          f"{alone:.3f} episodes/s ({threads[0]:.3f} in the consumer's thread, {alone8:.3f} "
          f"with 8 decode threads; decoding an episode's 4 PNG files {decode_ms:.2f} ms of "
          f"{1e3 / threads[0]:.2f} ms on one thread); one batch "
          f"({nbytes / 1e6:.2f} MB, int32 labels {label_bytes / 1e6:.2f} MB) to the card: "
          f"pinned {pinned_ms:.3f} ms ({nbytes / pinned_ms / 1e6:.2f} GB/s), pageable "
          f"{pageable_ms:.3f} ms ({nbytes / pageable_ms / 1e6:.2f} GB/s) [{card}]")
    if not all(np.isfinite([fed, in_memory, alone, alone8, threads[0], pinned_ms,
                            pageable_ms])):
        raise AssertionError(f"feed timings: {row}")
    return row


def real_data_phase(card, modules):
    """``train.test.main``, replay and ``train_cwt.main`` on a PASCAL-layout
    PNG tree with cv2 and PIL blocked (configs/pascal.yaml needs neither);
    then ``train_head.main`` and ``train_match.main`` (``resize_np``, through
    cv2) and the tools on the same tree."""
    load_cfg, merge_cfg_from_list, cuda_inner_loop, cuda_pivot = modules
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry
    from few_shot_seg_cwt_tpu_torch.train import train_cwt, train_head

    os.makedirs("build", exist_ok=True)
    root = os.path.abspath(tempfile.mkdtemp(prefix="chip_smoke_voc_", dir="build"))
    try:
        with without_cv2_and_pil():
            t0 = time.perf_counter()
            present = write_voc_tree(root)
            print(f"real data: wrote {N_TREE} PNG images at VOC sizes {VOC_SIZES} with gray "
                  f"PNG masks in {time.perf_counter() - t0:.1f} s")
            data = ["data_root", root, "train_list", os.path.join(root, "train.txt"),
                    "val_list", os.path.join(root, "val.txt"), "workers", "4"]

            def cfg(path, *opts):
                out = merge_cfg_from_list(load_cfg(path), data + list(opts))
                out.scan_cache = os.path.join(root, ".scan_cache")
                return out

            # ---- the evaluation entry point on the tree, counted ----
            tcfg = cfg("configs/pascal.yaml", "episode_batch", str(E), "test_num", "64",
                       "n_runs", "2")
            if (tcfg.image_size, tcfg.adapt_iter) != (IMG, STEPS):
                raise AssertionError("configs/pascal.yaml no longer gives 473 px, 200 steps")
            lines = []
            cuda_inner_loop.reset_launches()
            t0 = time.perf_counter()
            miou = test_entry.main(tcfg, device="cuda", log=lines.append)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(cuda_inner_loop.LAUNCHES)
            runtime = next(str(l) for l in lines if str(l).startswith("Average runtime"))
            print(f"real data: train.test.main (configs/pascal.yaml, 2 runs x 64 episodes in "
                  f"batches of {E}, 4 decode threads, random init): mIoU {miou:.4f}, "
                  f"{wall:.1f} s wall; {runtime}; launches {launches} [{card}]")
            if launches["adapt_binary"] < 1 or not np.isfinite(miou):
                raise AssertionError(f"real-data eval: launches {launches}, mIoU {miou}")

            # ---- the feed: loader against episodes on the card ----
            fcfg = tcfg.clone()
            fcfg.val_list = os.path.join(root, "feed.txt")
            feed = [feed_timings(fcfg, dtype, card) for dtype in ("float32", "bfloat16")]

            # ---- replay a log twice: one stream across runs ----
            log_path = os.path.join(root, "episodes.jsonl")
            write_episode_log(log_path, present)
            replays = []
            for _ in range(2):
                lines = []
                rcfg = cfg("configs/pascal.yaml", "episode_batch", str(E), "test_num", "16",
                           "n_runs", "2", "replay", log_path)
                replays.append((test_entry.main(rcfg, device="cuda", log=lines.append),
                                class_lines(lines)))
            (m1, runs1), (m2, runs2) = replays
            print(f"real data: replay of a 32-episode log, 2 runs x 16, twice: mIoU {m1:.4f} "
                  f"and {m2:.4f}; run 1 {runs1[0]}, run 2 {runs1[1]}")
            if runs1 != runs2:
                raise AssertionError(f"replay differs between invocations: {runs1} {runs2}")
            run_classes = [{int(l.split()[1]) for l in r} for r in runs1]
            if run_classes != [{1, 2}, {3, 4, 5}]:
                raise AssertionError(f"replay run 2 does not start at log episode 16: "
                                     f"classes per run {run_classes}")

            # ---- the CWT trainer on the tree (K2 at tile 2) ----
            lines = []
            cuda_inner_loop.reset_launches()
            with inner_tile(2):
                best = train_cwt.main(cfg("configs/pascal.yaml", "debug", "True", "epochs",
                                          "1", "episode_batch", "2", "test_num", "8",
                                          "n_runs", "1"), device="cuda", log=lines.append)
            torch.cuda.synchronize()
            cwt_launches = dict(cuda_inner_loop.LAUNCHES)
            epoch_line = next(str(l) for l in lines if str(l).startswith("Epoch 1:"))
            print(f"real data: train_cwt.main (debug: 5 steps of 2 episodes, "
                  f"FSS_INNER_TILE=2): {epoch_line}; best val mIoU {best:.4f}; launches "
                  f"{cwt_launches}")
            if cwt_launches["adapt_binary_tiled"] < 1 or not np.isfinite(best):
                raise AssertionError(f"real-data CWT training: {cwt_launches}, {best}")

        # ---- the MMN trainer on pascal_mmn.yaml as shipped, flat route ----
        # (resize_np: cv2's resize, as the JAX package runs it)
        lines = []
        cuda_inner_loop.reset_launches()
        cuda_pivot.reset_launches()
        hcfg = cfg("configs/pascal_mmn.yaml", "epochs", "1", "iter_per_epoch", "4",
                   "episode_batch", "2", "test_num", "4", "save_models", "False")
        if not (hcfg.use_amp and hcfg.augmentations == ["hor_flip", "resize_np"]):
            raise AssertionError("configs/pascal_mmn.yaml changed: use_amp, augmentations")
        with contextlib.chdir(root), pivot_route(True):   # its results/ goes with the tree
            best = train_head.main(hcfg, "mmn", device="cuda", log=lines.append)
        head_log = log_txt_val(os.path.join(root, train_head.results_dir(hcfg, "mmn")),
                               "val: mIoU")
        torch.cuda.synchronize()
        mmn_launches = launch_counts(cuda_inner_loop, cuda_pivot)
        val_line = next(str(l) for l in lines if str(l).startswith("val: mIoU"))
        print(f"real data: train_head.main (configs/pascal_mmn.yaml as shipped: use_amp, "
              f"hor_flip + resize_np through cv2; 2 steps of 2, FSS_PIVOT_MXU=1): {val_line}; "
              f"launches {mmn_launches}; log.txt {head_log}")
        if min(mmn_launches[k] for k in ("pivot_fwd", "pivot_dw")) < 1 \
                or not np.isfinite(best):
            raise AssertionError(f"real-data MMN training: {mmn_launches}, {best}")
        match_launches = train_match_entry(root, load_cfg, merge_cfg_from_list,
                                           cuda_inner_loop, cuda_pivot)
        tools_on_tree(root, load_cfg, merge_cfg_from_list)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"eval_launches": launches, "train_cwt_launches": cwt_launches,
            "train_head_launches": mmn_launches, "train_match_launches": match_launches,
            "feed": feed}


def train_match_entry(root, load_cfg, merge_cfg_from_list, cuda_inner_loop, cuda_pivot):
    """``train_match.main`` on configs/pascal_match.yaml and the PNG tree at
    ``root``, flat route: one epoch of 2 steps of 2 with its train state
    saved, then a ``debug`` run (5 steps) resuming from that state for the
    second epoch. Runs in ``root`` (its ``results/`` goes with the tree)."""
    from few_shot_seg_cwt_tpu_torch.train import train_match

    root = os.path.abspath(root)
    data = ["data_root", root, "train_list", os.path.join(root, "train.txt"),
            "val_list", os.path.join(root, "val.txt"), "workers", "4"]
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_match.yaml"), data + [
        "epochs", "2", "stop_after_epochs", "1", "iter_per_epoch", "4", "episode_batch", "2",
        "test_num", "4", "save_models", "True"])
    cfg.scan_cache = os.path.join(root, ".scan_cache")
    lines = []
    cuda_inner_loop.reset_launches()
    cuda_pivot.reset_launches()
    with contextlib.chdir(root), pivot_route(True):
        best = train_match.main(cfg, device="cuda", log=lines.append)
        torch.cuda.synchronize()
        launches = launch_counts(cuda_inner_loop, cuda_pivot)
        state = [os.path.join(d, "train_state.pt") for d, _, files in os.walk("results")
                 if "train_state.pt" in files]
        if len(state) != 1:
            raise AssertionError(f"train_match.main saved no single train state: {state}")
        rcfg = cfg.clone()
        rcfg.debug, rcfg.stop_after_epochs, rcfg.resume_ckpt = True, None, state[0]
        resumed = []
        best2 = train_match.main(rcfg, device="cuda", log=resumed.append)
        match_log = log_txt_val(os.path.dirname(state[0]), "val: mIoU")
    val_line = next(str(l) for l in lines if str(l).startswith("val: mIoU"))
    resume_line = next((str(l) for l in resumed if "resumed full head train state" in str(l)),
                       None)
    epoch_line = next((str(l) for l in resumed if str(l).startswith("==== Epoch 2")), None)
    print(f"real data: train_match.main (configs/pascal_match.yaml, FSS_PIVOT_MXU=1, 2 steps "
          f"of 2): {val_line}; launches {launches}; then debug with resume_ckpt: "
          f"{resume_line}; {epoch_line}; best {best:.4f} / {best2:.4f}; log.txt {match_log}")
    if min(launches[k] for k in ("adapt_binary", "pivot_fwd", "pivot_dw")) < 1 \
            or resume_line is None or epoch_line is None or not np.isfinite(best2):
        raise AssertionError(f"real-data match training: {launches}, {resume_line}, "
                             f"{epoch_line}, {best2}")
    return launches


# ---- stage-1 pretraining, VGG and the bench ----

PRE_BATCH, PRE_CLASSES, PRE_STEPS = 10, 16, 3   # configs/pascal_pretrain.yaml


def pretrain_steps_phase(card, load_cfg):
    """(a) The stage-1 step at full width (configs/pascal_pretrain.yaml:
    ResNet-50, 473 px, batch 10, 16 classes, label smoothing, scale_lr 2),
    plain and with mixup: finite losses; images/s, ms a step and peak
    memory over PRE_STEPS steps after a warm-up."""
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
    from few_shot_seg_cwt_tpu_torch.train.pretrain import (build_pretrain_optimizer,
                                                           make_pretrain_step)

    cfg = load_cfg("configs/pascal_pretrain.yaml")
    got = (cfg.image_size, cfg.batch_size, cfg.num_classes_tr, cfg.smoothing, cfg.scale_lr,
           cfg.layers, cfg.arch)
    if got != (IMG, PRE_BATCH, PRE_CLASSES, True, 2.0, 50, "resnet"):
        raise AssertionError(f"configs/pascal_pretrain.yaml no longer gives the stage-1 "
                             f"step: {got}")
    dev = torch.device("cuda")
    model = build_pspnet(cfg).to(dev)
    optimizer, scheduler = build_pretrain_optimizer(model, cfg, iters_per_epoch=100)
    rng = np.random.default_rng(40)
    img = torch.tensor(rng.standard_normal((PRE_BATCH, IMG, IMG, 3)).astype(np.float32),
                       device=dev)
    gt_np = rng.integers(0, PRE_CLASSES, (PRE_BATCH, IMG, IMG)).astype(np.int32)
    gt_np[:, :40] = 255
    gt = torch.tensor(gt_np, device=dev)
    out = {}
    for mixup in (False, True):
        mcfg = cfg.clone()
        mcfg.mixup = mixup
        step = make_pretrain_step(model, optimizer, scheduler, mcfg)
        gen = torch.Generator().manual_seed(41)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(img, gt, gen)["loss"])]                  # warm-up
        s = host_seconds(lambda: losses.append(float(step(img, gt, gen)["loss"])), PRE_STEPS)
        peak = peak_gib()
        name = "mixup" if mixup else "plain"
        print(f"pretrain step ({name}; configs/pascal_pretrain.yaml: ResNet-50, {IMG} px, "
              f"batch {PRE_BATCH}, {PRE_CLASSES} classes, smoothing, scale_lr 2, fp32, TF32 "
              f"off): {PRE_BATCH / s:.3f} images/s, {s * 1e3:.1f} ms a step (median of "
              f"{PRE_STEPS}), peak {peak:.2f} GiB; losses {np.round(losses, 4).tolist()} "
              f"[{card}]")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"pretrain step ({name}): non-finite loss {losses}")
        if not mixup:
            device_profile(lambda: step(img, gt, gen), f"pretrain step ({name}), "
                           "torch.profiler", card, groups=(
                               ("conv forward", ("fprop",)), ("conv dgrad", ("dgrad",)),
                               ("conv wgrad", ("wgrad",)), ("batch norm", ("batch_norm", "bn_")),
                               ("gemm (resize, PPM pools)", ("gemm", "sgemm")),
                               ("elementwise", ("elementwise", "vectorized", "reduce"))))
        out[name] = dict(images_per_s=PRE_BATCH / s, ms=s * 1e3, peak_gib=peak)
    return out


def pretrain_entry_phase(card, modules):
    """(b) ``train.pretrain.main`` on a PNG tree (4 decode threads): one epoch
    with standard validation, then one with episodic validation, where K1
    must launch; then stage 2 (``train.test.main``) loads the ``best.ckpt``
    it wrote from the stage-1 schema."""
    load_cfg, merge_cfg_from_list, cuda_inner_loop = modules
    from few_shot_seg_cwt_tpu_torch.train import pretrain
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry
    from few_shot_seg_cwt_tpu_torch.train.common import stage1_weights_path
    from few_shot_seg_cwt_tpu_torch.utils.tb import read_scalars

    os.makedirs("build", exist_ok=True)
    root = os.path.abspath(tempfile.mkdtemp(prefix="chip_smoke_pretrain_", dir="build"))
    try:
        with without_cv2_and_pil():
            write_voc_tree(root)
            data = ["data_root", root, "train_list", os.path.join(root, "train.txt"),
                    "val_list", os.path.join(root, "val.txt"), "workers", "4"]

            def cfg(path, *opts):
                out = merge_cfg_from_list(load_cfg(path), data + list(opts))
                out.scan_cache = os.path.join(root, ".scan_cache")
                return out

            runs = {}
            for episodic in (False, True):
                pcfg = cfg("configs/pascal_pretrain.yaml", "epochs", "1", "episodic_val",
                           str(episodic), "exp_name", "chip_smoke_" + ("ep" if episodic else "std"),
                           "episode_batch", str(E), "test_num", "16", "n_runs", "1",
                           "log_freq", "1")
                lines = []
                cuda_inner_loop.reset_launches()
                t0 = time.perf_counter()
                with contextlib.chdir(root):   # its results/ goes with the tree
                    best = pretrain.main(pcfg, device="cuda",
                                         log=lambda l: lines.append(str(l)))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(cuda_inner_loop.LAUNCHES)
                epoch = next(l for l in lines if l.startswith("===== Epoch 0"))
                val = next(l for l in lines if l.startswith(
                    "episodic_validate run" if episodic else "Testing results"))
                print(f"train.pretrain.main ({'episodic' if episodic else 'standard'} "
                      f"validation; the tree's 32 train images in batches of {PRE_BATCH}, "
                      f"16 val images): {epoch} {val}; best {best:.4f}; {wall:.1f} s wall; "
                      f"launches {launches} [{card}]")
                if not np.isfinite(best):
                    raise AssertionError(f"pretrain.main returned {best}")
                if episodic and launches["adapt_binary"] < 1:
                    raise AssertionError(f"episodic validation did not launch K1: {launches}")
                sv = os.path.join(root, pretrain.save_dir(pcfg))
                logged = log_txt_val(sv, val.split()[0])
                scalars = read_scalars(os.path.join(sv, "model"))
                print(f"train.pretrain.main log.txt: {logged}; scalars "
                      f"{ {k: v for k, v in sorted(scalars.items())} } "
                      f"({sorted(os.listdir(os.path.join(sv, 'model')))})")
                if not {"train_loss", "mean_iou/val"} <= set(scalars):
                    raise AssertionError(f"pretrain scalars: {scalars}")
                runs["episodic" if episodic else "standard"] = dict(
                    launches=launches["adapt_binary"], best=best,
                    ckpt=os.path.join(sv, "best.ckpt"))

            # stage 2 on the stage-1 weights, through the reference's schema
            weights = os.path.join(root, "weights")
            tcfg = cfg("configs/pascal.yaml", "resume_weights", weights, "episode_batch",
                       str(E), "test_num", "16", "n_runs", "1")
            path = stage1_weights_path(tcfg)
            os.makedirs(os.path.dirname(path))
            shutil.copyfile(runs["episodic"]["ckpt"], path)
            lines = []
            miou = test_entry.main(tcfg, device="cuda", log=lambda l: lines.append(str(l)))
            loaded = f"=> loaded weight '{path}'"
            print(f"train.test.main on the stage-1 best.ckpt: '{loaded}' logged: "
                  f"{loaded in lines}; mIoU {miou:.4f}")
            if loaded not in lines or not np.isfinite(miou):
                raise AssertionError(f"stage 2 did not load the stage-1 weights: {lines[:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


def vgg_phase(card, calib_images, modules):
    """(c) One episodic eval batch of 8 with ``arch vgg`` (30x30 features at
    473 px), BN calibrated: counted, K1 at its shapes against the plain loop
    (1e-4 * max|acc|) and the masks against the plain loop's (>= 99.5%),
    K1 timed beside its bound."""
    (load_cfg, merge_cfg_from_list, EpisodicEngine, make_episode_batch, cuda_inner_loop,
     binary_pixel_weights, cuda_ms) = modules
    cfg = merge_cfg_from_list(load_cfg("configs/pascal.yaml"),
                              ["arch", "vgg", "episode_batch", str(E), "cls_lr", str(CLS_LR)])
    engine = EpisodicEngine(cfg, device="cuda")
    calibrate_batchnorm(engine.backbone, calib_images)
    episodes = make_episode_batch(17, E, size=IMG, shot=SHOT)
    w0 = engine.init_weights(E, torch.Generator().manual_seed(18))
    batch = engine.to_device(episodes)
    cuda_inner_loop.reset_launches()
    masks = engine.serve_batch(episodes, w0=w0)
    metrics = engine.eval_metrics_batch_no_cwt(episodes, w0=w0)
    torch.cuda.synchronize()
    launches = dict(cuda_inner_loop.LAUNCHES)
    with torch.no_grad():
        f_s, f_q = engine._episode_features(batch)
        pw, pwy = binary_pixel_weights(batch["s_label"])
        u0 = (w0[:, 1] - w0[:, 0]).contiguous()
        acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, STEPS, CLS_LR)
        acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS, CLS_LR)
        w_plain = torch.stack([w0[:, 0] + CLS_LR * acc_p, w0[:, 1] - CLS_LR * acc_p], dim=1)
        masks_plain = engine.mask_from_prediction(engine._predict(f_q, w_plain)[0], (IMG, IMG))
    torch.cuda.synchronize()
    err, tol = float((acc_k - acc_p).abs().max()), 1e-4 * float(acc_p.abs().max())
    agree = float((masks == masks_plain).float().mean())
    h = f_s.shape[2]
    ms = cuda_ms(lambda: cuda_inner_loop.launch(cuda_inner_loop.load_library(), f_s, pw, pwy,
                                                u0, STEPS, CLS_LR), 5)
    plain_ms = cuda_ms(lambda: cuda_inner_loop.adapt_binary_reference(
        f_s, pw, pwy, u0, STEPS, CLS_LR), 3)
    flops, nbytes = inner_loop_work(E, SHOT, h, h, CH, IMG, IMG, STEPS)
    b_ms, b_by = bound(flops, nbytes)
    print(f"VGG episodic eval (arch vgg, {h}x{h} features, batch of {E}): launches "
          f"{launches}; K1 max|acc_k - acc_p| = {err:.3e} (tolerance 1e-4 * max|acc_p| = "
          f"{tol:.3e}); masks against the plain loop's {agree:.6f} (>= 0.995 needed); K1 "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) [{card}]")
    if h != -(-IMG // 16) or launches["adapt_binary"] < 1:    # ceil-mode pools: 30 at 473
        raise AssertionError(f"VGG path: features {h}x{h}, launches {launches}")
    if not np.isfinite(err) or err > tol or agree < 0.995:
        raise AssertionError(f"VGG K1: error {err} > {tol} or masks {agree} < 0.995")
    if not all(torch.isfinite(metrics[k]).all() for k in ("inter0", "union0", "loss0")):
        raise AssertionError("VGG no-CWT metrics are not finite")
    return dict(launches=launches["adapt_binary"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def bench_phase(card):
    """(d) ``tools.bench.run`` in every mode, 5 timed batches: the pivot
    kernels on the flat route in the MMN modes, K2 (FSS_INNER_TILE=2) in
    the CWT train step; each JSON line printed."""
    from few_shot_seg_cwt_tpu_torch.tools import bench

    lines = {}
    for mode in bench.MODES:
        flat = mode.startswith("head")
        with pivot_route(flat), inner_tile(2 if mode == "train" else None):
            out = bench.run(mode, device="cuda", batches=5, quiet=1)
        print(f"bench {json.dumps(out)}")
        if not (np.isfinite(out["value"]) and np.isfinite(out["mfu"])):
            raise AssertionError(f"bench {mode}: {out}")
        want = {"eval": "adapt_binary", "train": "adapt_binary_tiled",
                "head": "pivot_dw", "head_eval": "pivot_fwd", "head_serve": "pivot_fwd"}
        if mode in want and out["kernel_launches"].get(want[mode], 0) < 1:
            raise AssertionError(f"bench {mode} did not launch {want[mode]}: "
                                 f"{out['kernel_launches']}")
        lines[mode] = out
        torch.cuda.empty_cache()
    return lines


# ---- 12. the tools: serve artifacts, the profiler trace, the tools on a tree ----


def module_state(module) -> dict:
    """A module's state_dict copied to the host (to rebuild it later)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


def run_loaded(path, inputs, out):
    """``tools/serve_loaded.py`` on an artifact in a fresh process: its
    JSON result line and its masks."""
    proc = subprocess.run([sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.tools.serve_loaded",
                           path, inputs, out, "--reps", "3"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{path}: the serving process failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), torch.load(out, weights_only=True)


def serve_artifact(name, engine, export, episodes, w0, work, card, flat=False):
    """Export ``engine``'s serve program at the batch of ``episodes`` with
    ``export`` (tracing launches no kernel), save it, and run it in a fresh
    process that imports only torch and the port's ``ops``
    (``tools/serve_loaded.py``, TF32 off as in every entry point): its masks
    against the engine's eager ``serve_batch`` on the same inputs (>= 99.5%
    equal), its launches, its episodes/s beside eager's. Returns the loaded
    program's launches and figures."""
    e = len(episodes["q_img"])
    path = os.path.join(work, f"{name}_serve.pt2")
    with pivot_route(flat):
        t0 = time.perf_counter()
        exported = export(engine, e)
        export_s = time.perf_counter() - t0
        torch.export.save(exported, path)
        eager = engine.serve_batch(episodes, w0=w0)
        eager_s = host_seconds(lambda: engine.serve_batch(episodes, w0=w0), 3)
    inputs = os.path.join(work, f"{name}_inputs.pt")
    torch.save({"s_img": torch.as_tensor(episodes["s_img"]),
                "s_label": torch.as_tensor(episodes["s_label"]).int(),
                "q_img": torch.as_tensor(episodes["q_img"]), "w0": w0.cpu()}, inputs)
    out = os.path.join(work, f"{name}_masks.pt")
    loaded, masks = run_loaded(path, inputs, out)
    agree = float((masks == eager.cpu()).float().mean())
    launches = {k: v for k, v in loaded["launches"].items() if v}
    heavy = [m for m in loaded["port_modules"]
             if m.split(".")[1] in ("models", "episodic", "train", "eval", "data")]
    print(f"{name} serve artifact (batch {e}): export {export_s:.2f} s, "
          f"{os.path.getsize(path) / 2**20:.1f} MiB; loaded in a fresh process (imports "
          f"{len(loaded['port_modules'])} port modules, none of models/episodic) in "
          f"{loaded['load_s']:.2f} s: launches {launches}, masks equal to eager serve_batch "
          f"on {agree:.6f} of pixels; {loaded['episodes_per_s']:.3f} episodes/s loaded vs "
          f"{e / eager_s:.3f} eager [{card}]")
    if heavy:
        raise AssertionError(f"{name} artifact: the serving process imported {heavy}")
    if agree < 0.995:
        raise AssertionError(f"{name} artifact: masks agree with eager on {agree:.4%}")
    return {"launches": launches, "export_s": export_s,
            "mib": os.path.getsize(path) / 2**20, "agree": agree,
            "episodes_per_s": loaded["episodes_per_s"], "eager_episodes_per_s": e / eager_s}


def tools_phase(card, cwt_state, episodes, w0, mmn, modules):
    """(a) the CWT serve artifact at batch 8 on the calibrated weights of
    phase 4, (b) the MMN one on configs/pascal_mmn.yaml as shipped on the
    flat route at batch 4 (weights of phase 6), each loaded in a fresh
    process; (c) ``validate_transformer`` with ``profile_dir`` (1 run x 16
    episodes): the trace names K1's kernel."""
    load_cfg, merge_cfg_from_list, EpisodicEngine, HeadEngine = modules
    from few_shot_seg_cwt_tpu_torch.eval.validate import validate_transformer
    from few_shot_seg_cwt_tpu_torch.tools import export_serve
    from few_shot_seg_cwt_tpu_torch.train.common import episodic_val_loader

    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir="build")
    try:
        cfg = merge_cfg_from_list(load_cfg("configs/pascal.yaml"), [
            "cls_lr", str(CLS_LR), "episode_batch", str(E)])
        engine = EpisodicEngine(cfg, device="cuda")
        engine.backbone.load_state_dict(cwt_state["backbone"])
        engine.cwt.load_state_dict(cwt_state["cwt"])
        cwt = serve_artifact("CWT", engine, lambda eng, e: export_serve.build_serve_export(
            cfg, eng, e), episodes, w0, work, card)
        if cwt["launches"].get("adapt_binary", 0) < 1:
            raise AssertionError(f"the loaded CWT artifact launched {cwt['launches']}")

        mcfg, mmn_state, mmn_episodes, mmn_w0 = mmn
        with pivot_route(True):
            mmn_engine = HeadEngine(mcfg, "mmn", device="cuda")
        mmn_engine.backbone.load_state_dict(mmn_state["backbone"])
        mmn_engine.head.load_state_dict(mmn_state["head"])
        mmn_art = serve_artifact(
            "MMN", mmn_engine, lambda eng, e: export_serve.build_head_serve_export(
                mcfg, "mmn", eng, e), mmn_episodes, mmn_w0, work, card, flat=True)
        if min(mmn_art["launches"].get(k, 0) for k in ("adapt_binary", "pivot_fwd")) < 1:
            raise AssertionError(f"the loaded MMN artifact launched {mmn_art['launches']}")
        del mmn_engine

        # ---- the profiler trace of validate_transformer ----
        pcfg = merge_cfg_from_list(cfg.clone(), [
            "synthetic_data", "True", "test_num", "16", "n_runs", "1",
            "profile_dir", os.path.join(work, "profile")])
        lines = []
        miou, _ = validate_transformer(pcfg, engine, episodic_val_loader(pcfg, device="cuda"),
                                       log=lines.append)
        trace = next(str(l) for l in lines if "profile trace written" in str(l)).split()[-1]
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        k1 = [ev for ev in events if ev.get("cat") == "kernel"
              and "adapt_binary_kernel" in ev.get("name", "")]
        ops = sum(1 for ev in events if ev.get("name") == "fss::adapt_binary")
        print(f"validate_transformer with profile_dir (1 run x 16 episodes, mIoU {miou:.4f}): "
              f"{os.path.getsize(trace) / 2**20:.1f} MiB Chrome trace, {len(events)} events, "
              f"{len(k1)} adapt_binary_kernel launches ({sum(ev['dur'] for ev in k1) / 1e3:.3f} "
              f"ms), {ops} fss::adapt_binary operator calls [{card}]")
        if not k1:
            raise AssertionError("the profile_dir trace does not name K1's kernel")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"cwt": cwt, "mmn": mmn_art, "trace_k1": len(k1)}


def tools_on_tree(root, load_cfg, merge_cfg_from_list):
    """On the real-data phase's PNG tree: ``preflight`` with a stage-1 .pth
    and a CWT .pth saved from the port's random init (exit 0) and with the
    stage-1 .pth removed (exit 1); ``convert_ckpt strip-module`` then
    ``to-port`` give back the PSPNet's state_dict; ``bench_loader`` on the
    tree prints its JSON line."""
    from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
    from few_shot_seg_cwt_tpu_torch.tools import bench_loader, preflight
    from few_shot_seg_cwt_tpu_torch.train.common import trans_ckpt_dir
    from few_shot_seg_cwt_tpu_torch.utils import convert_ckpt
    from few_shot_seg_cwt_tpu_torch.utils.ckpt import load_ckpt

    stage1 = os.path.join(root, "stage1.pth")
    opts = ["data_root", root, "train_list", os.path.join(root, "train.txt"), "val_list",
            os.path.join(root, "val.txt"), "resume_weights", stage1, "model_dir",
            os.path.join(root, "model"), "ckpt_used", "best"]
    cfg = merge_cfg_from_list(load_cfg("configs/pascal.yaml"), opts)
    sd = build_pspnet(cfg).state_dict()
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in sd.items()}}, stage1)
    trans = os.path.join(trans_ckpt_dir(cfg), "best.pth")
    os.makedirs(os.path.dirname(trans), exist_ok=True)
    torch.save(build_cwt(cfg).state_dict(), trans)
    args = ["--config", "configs/pascal.yaml", "--opts", *opts]
    with contextlib.redirect_stdout(io.StringIO()) as ready:
        rc_ready = preflight.main(args)
    os.replace(stage1, stage1 + ".away")
    with contextlib.redirect_stdout(io.StringIO()) as missing:
        rc_missing = preflight.main(args)
    os.replace(stage1 + ".away", stage1)
    fails = [l.strip() for l in missing.getvalue().splitlines() if l.strip().startswith("FAIL")]
    print(f"preflight on the PNG tree: exit {rc_ready} with the stage-1 .pth "
          f"({sum('PASS' in l for l in ready.getvalue().splitlines())} PASS lines), exit "
          f"{rc_missing} without it: {fails}")
    if (rc_ready, rc_missing) != (0, 1):
        raise AssertionError(f"preflight exits {rc_ready}, {rc_missing}:\n{ready.getvalue()}")

    stripped, ported = os.path.join(root, "stripped.pth"), os.path.join(root, "ported.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        convert_ckpt.main(["strip-module", stage1, stripped])
        convert_ckpt.main(["to-port", "pspnet", stripped, ported])
    back = load_ckpt(ported)
    same = back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    print(f"convert_ckpt strip-module + to-port: {len(back)} tensors, equal to the "
          f"PSPNet's state_dict: {same}")
    if not same:
        raise AssertionError("convert_ckpt did not give back the state_dict")

    with contextlib.redirect_stdout(io.StringIO()) as out:
        bench_loader.main(["--data-root", root, "--list", os.path.join(root, "train.txt"),
                           "--episodes", "64", "--batch", str(E), "--workers", "4",
                           "--device", "cuda"])
    line = out.getvalue().strip().splitlines()[-1]
    print(f"bench_loader on the PNG tree: {line}")
    if not np.isfinite(json.loads(line)["value"]):
        raise AssertionError(f"bench_loader: {line}")
    print("record_episodes and parity_drill: not run, the reference tree (its src/ "
          "sampler) is not on this machine")


# ---- 13. scale-out: data parallelism over processes ----


def scale_out_layout():
    """(processes, backend, shared card): NCCL one process a card on
    ``min(cards, 4)`` cards; with one card two processes on ``cuda:0`` over
    gloo (NCCL refuses two ranks on one card)."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        return min(cards, 4), "nccl", False
    return 2, "gloo", True


def scale_out_phase(card, cwt_state, mmn_state):
    """``parallel/dryrun.py`` at full width (473 px, ResNet-50, adapt_iter
    200, TF32 off in every process): the CWT train step of 8 on K1 and K2,
    the MMN step of pascal_mmn.yaml as shipped (flat route, fp32 and bf16
    head), the stage-1 step at batch 10 (dropout and mixup off, the JAX
    package's self-calibrating bar), one gathered eval batch of 8,
    ``validate_transformer`` and ``episodic_validate``, and the collectives;
    a reference process runs each step alone and in a group of one over
    NCCL. Every row must hold; every rank must launch K1, K2, pivot_fwd and
    pivot_dw. Returns the rows by check."""
    from few_shot_seg_cwt_tpu_torch.parallel import dryrun

    world, backend, shared = scale_out_layout()
    print(f"scale-out: {world} processes over {backend} on "
          f"{1 if shared else world} card(s) of {torch.cuda.device_count()}"
          + (" (both ranks on cuda:0, named explicitly: they time-slice the card, so their "
             "times are not a scale-out figure)" if shared else "") + f" [{card}]")
    spec = dryrun.default_spec(IMG, STEPS)
    spec["cwt"]["weights"] = spec["eval"]["weights"] = spec["validate"]["weights"] = cwt_state
    spec["mmn"]["weights"] = mmn_state
    spec["mmn"]["episodes"] = max(2, world)
    spec["pretrain"]["batch"] = 10 if 10 % world == 0 else -(-10 // world) * world
    spec["validate"]["episodes"] = max(4, world)
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir="build")
    t0 = time.perf_counter()
    try:
        rows = dryrun.launch(world, backend, "cuda", spec, work, threads=4, timeout=600)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"scale-out dryrun: {time.perf_counter() - t0:.1f} s for the reference process and "
          f"{world} ranks")
    brief = ("launches", "plain_launches", "world1_launches")
    for row in rows:
        print("scale-out " + json.dumps({k: v for k, v in row.items() if k not in brief},
                                        default=float))
    by = {}
    for row in rows:
        by.setdefault(row["check"], []).append(row)
    bad = [r["check"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"scale-out checks failed: {bad}")
    counts = {
        "adapt_binary": next(r for r in by["cwt_step"] if r["tile"] == 1),
        "adapt_binary_tiled": next(r for r in by["cwt_step"] if r["tile"] == 2),
        "pivot_fwd": next(r for r in by["mmn_step"] if r["head"] == "fp32_head"),
        "pivot_dw": next(r for r in by["mmn_step"] if r["head"] == "fp32_head"),
    }
    scale_out = {}
    for name, row in counts.items():
        per_rank = [l[name] for l in row["launches"]]
        scale_out[name] = {"world": world, "backend": backend, "shared_card": shared,
                           "launches_per_rank": per_rank,
                           "world1_launches": row["plain_launches"][name]}
        print(f"scale-out launches of {name} in the {row['check']} step: per rank {per_rank}, "
              f"one process on the whole batch {row['plain_launches'][name]}")
        if min(per_rank) < 1:
            raise AssertionError(f"a rank did not launch {name} in the scale-out step: {per_rank}")
    for row in by["cwt_step"] + by["mmn_step"] + by["pretrain_step"]:
        label = row["check"] + (f" tile {row['tile']}" if "tile" in row else "") + (
            f" {row['head']}" if "head" in row else "")
        print(f"scale-out {label}: ms per rank {row['ms']} (warm {row['warm_ms']}), one "
              f"process {row['plain_ms']} ms (warm {row['plain_warm_ms']}); gradient all-reduce "
              f"{row['allreduce_ms']} ms per rank for {row['allreduce_bytes']} B; peak "
              f"{row['peak_gib']} GiB per rank [{card}; "
              f"{'one card time-sliced by both ranks' if shared else 'one card a rank'}]")
    return by, scale_out


def torchrun_trainers_phase(card):
    """``torchrun`` (``python -m torch.distributed.run --standalone``) of
    ``train.train_ddp`` (configs/pascal_ddp.yaml) and ``train.train_cwt``
    (configs/pascal.yaml) on synthetic episodes at 473 px, both jobs at
    once: one epoch, saved, then a second launch resuming it by
    ``auto_resume``. Rank 0 alone writes each ``log.txt`` (one validation
    line an epoch), both ranks resume (the trainers check every epoch that
    the ranks' weights and generators agree), and the train state holds
    every rank's generator state."""
    world, backend, shared = scale_out_layout()
    # the trainers run in a directory of their own, and import the port from here
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(".")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if shared:
        env.update(FSS_DIST_DEVICE="cuda:0", FSS_DIST_BACKEND="gloo")
    e = max(2, world)
    run_dir = os.path.abspath(tempfile.mkdtemp(prefix="chip_smoke_torchrun_", dir="build"))
    jobs = {
        "train_ddp": ("configs/pascal_ddp.yaml", [
            "synthetic_data", "True", "epochs", "2", "iter_per_epoch", str(2 * e),
            "episode_batch", str(e), "test_num", str(2 * e), "save_models", "True"]),
        "train_cwt": ("configs/pascal.yaml", [
            "synthetic_data", "True", "epochs", "2", "iter_per_epoch", str(2 * E),
            "episode_batch", str(E), "test_num", str(E), "n_runs", "1", "save_models", "True",
            "model_dir", os.path.join(run_dir, "model")]),
    }
    out = {}
    try:
        for launch, extra in (("first", ["stop_after_epochs", "1"]),
                              ("resume", ["auto_resume", "True"])):
            t0 = time.perf_counter()
            procs = {name: subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(world), "-m",
                 f"few_shot_seg_cwt_tpu_torch.train.{name}", "--config",
                 os.path.abspath(config), "--opts", *opts, *extra],
                cwd=run_dir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for name, (config, opts) in jobs.items()}
            for name, proc in procs.items():
                stdout, stderr = proc.communicate(timeout=400)
                if proc.returncode != 0:
                    raise AssertionError(f"torchrun {name} ({launch}) exited {proc.returncode}:\n"
                                         f"{stdout[-2000:]}\n{stderr[-3000:]}")
                out[(name, launch)] = stdout
            print(f"torchrun --nproc_per_node {world} ({launch} launch of train_ddp and "
                  f"train_cwt at once): {time.perf_counter() - t0:.1f} s [{card}]")
        for name, val, resumed in (("train_ddp", "val: mIoU",
                                    "=> resumed full head train state after epoch 1"),
                                   ("train_cwt", "mIoU---Val result",
                                    "=> resumed full train state at epoch 1")):
            logs = [os.path.join(d, "log.txt") for d, _, files in os.walk(run_dir)
                    if "log.txt" in files and (("model" in d) == (name == "train_cwt"))]
            if len(logs) != 1:
                raise AssertionError(f"{name}: log.txt files {logs}")
            with open(logs[0]) as f:
                lines = f.read().splitlines()
            vals = [l for l in lines if l.startswith(val)]
            states = [os.path.join(d, f) for d, _, files in os.walk(os.path.dirname(logs[0]))
                      for f in files if f.startswith("train_state")]
            state = torch.load(states[0], map_location="cpu", weights_only=True)
            finals = [f for f in os.listdir(os.path.dirname(logs[0])) if f.startswith("final")]
            print(f"torchrun {name}: log.txt {len(lines)} lines, validation lines {vals}; "
                  f"resume line in the second launch's output: "
                  f"{resumed in out[(name, 'resume')]}; train state epoch "
                  f"{state['meta']['epoch']}, world {state['meta']['world']}, rng_ranks "
                  f"{tuple(state['rng_ranks'].shape)}; final checkpoint {finals}")
            if len(vals) != 2:
                raise AssertionError(f"{name}: {len(vals)} validation lines in log.txt (rank 0 "
                                     "alone writes one an epoch)")
            if resumed not in out[(name, "resume")] or not any(resumed in l for l in lines):
                raise AssertionError(f"{name}: the second launch did not resume")
            if state["meta"]["world"] != world or state["rng_ranks"].shape[0] != world:
                raise AssertionError(f"{name}: train state {state['meta']}")
            if not finals:
                raise AssertionError(f"{name}: no final checkpoint")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
    from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import (adapt_classifier_batch,
                                                                binary_pixel_weights,
                                                                pick_tile)
    from few_shot_seg_cwt_tpu_torch.models.conv4d import CenterPivotConv4d
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
    from few_shot_seg_cwt_tpu_torch.ops import cuda_build, cuda_inner_loop, cuda_pivot
    from few_shot_seg_cwt_tpu_torch.ops.corr import get_corr
    from few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop import cuda_ms
    from few_shot_seg_cwt_tpu_torch.train import test as test_entry
    from few_shot_seg_cwt_tpu_torch.train import train_cwt, train_head, train_kshot
    from few_shot_seg_cwt_tpu_torch.train.common import trans_ckpt_dir
    from few_shot_seg_cwt_tpu_torch.train.optim import build_optimizer

    for var in ROUTE_SWITCHES:
        os.environ.pop(var, None)

    # ---- 2. build every kernel: one nvcc per source, all at once ----
    t0 = time.perf_counter()
    cuda_build.build([cuda_inner_loop.build_spec(), cuda_pivot.build_spec()])
    cuda_inner_loop.load_library()
    cuda_pivot.load_library()
    print(f"build: 2 libraries (inner_loop.cu: K1, K2; pivot.cu: pivot_fwd, pivot_dw) in "
          f"{time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    rng = np.random.default_rng(2021)
    episodes = make_episode_batch(7, E, size=IMG, shot=SHOT)

    # ---- 3. kernel phase: K1 at main-path shapes ----
    f_s = torch.tensor(np.abs(rng.standard_normal((E, SHOT, FEAT, FEAT, CH)))
                       .astype(np.float32), device=dev)
    s_label = torch.tensor(episodes["s_label"], device=dev).long()
    pw, pwy = binary_pixel_weights(s_label)
    u0 = torch.tensor((rng.uniform(-2, 2, (E, CH)) / np.sqrt(CH)).astype(np.float32),
                      device=dev)
    acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, STEPS, CLS_LR)
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, STEPS, CLS_LR)
    torch.cuda.synchronize()
    k1_err = float((acc_k - acc_p).abs().max())
    k1_scale = float(acc_p.abs().max())
    k1_tol = 1e-4 * k1_scale
    print(f"K1 adapt_binary: max|acc_k - acc_p| = {k1_err:.3e} "
          f"(tolerance 1e-4 * max|acc_p| = {k1_tol:.3e})")
    if not np.isfinite(k1_err) or k1_err > k1_tol:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_err} > {k1_tol}")
    k1_rows = {}
    k1_lib = cuda_inner_loop.load_library()
    for e in (1, 2, 4, E):
        # each batch size partitions an episode differently (one row a CTA,
        # uneven slices, part of f streamed): held against the plain version,
        # and against the E = 8 launch's bits (the partition does not change
        # an episode's acc)
        args = [t[:e].contiguous() for t in (f_s, pw, pwy, u0)]
        acc_ke = cuda_inner_loop.adapt_binary(*args, STEPS, CLS_LR)
        plan = cuda_inner_loop.LAST_PLAN["adapt_binary"]
        err_e = float((acc_ke - acc_p[:e]).abs().max())
        same_e = bool(torch.equal(acc_ke, acc_k[:e]))
        print(f"K1 adapt_binary at E = {e}: max|acc_k - acc_p| = {err_e:.3e} (tolerance "
              f"{k1_tol:.3e}); equal bits to the E = {E} launch: {same_e}")
        if not np.isfinite(err_e) or err_e > k1_tol or not same_e:
            raise AssertionError(f"K1 at E = {e}: error {err_e} > {k1_tol} or bits differ "
                                 f"from E = {E} ({same_e})")
        k1_t = launch_and_op_ms(
            lambda a=args: cuda_inner_loop.launch(k1_lib, *a, STEPS, CLS_LR),
            lambda a=args: cuda_inner_loop.adapt_binary(*a, STEPS, CLS_LR))
        ms = k1_t["ms"]
        plain_ms = cuda_ms(
            lambda a=args: cuda_inner_loop.adapt_binary_reference(*a, STEPS, CLS_LR), 5)
        flops, nbytes = inner_loop_work(e, SHOT, FEAT, FEAT, CH, IMG, IMG, STEPS)
        b_ms, b_by = bound(flops, nbytes)
        k1_rows[e] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, dispatch=k1_t)
        print(f"K1 adapt_binary at E = {e}: {dispatch_text(k1_t)} [{card}]")
        print(f"K1 adapt_binary at E = {e}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
              f"grid {plan.grid} CTAs, {plan.ctas_per_group} CTAs per episode, plan "
              f"{json.dumps(plan.summary())}, library_ms null [{card}]")
        if plan.ctas_per_group < 2:
            raise AssertionError(f"K1 runs an episode on one CTA at E = {e}: {plan.summary()}")
    k1_ms, k1_plain_ms = k1_rows[E]["ms"], k1_rows[E]["plain_ms"]
    k1_dispatch = k1_rows[E]["dispatch"]
    k1_bound, k1_bound_by = k1_rows[E]["bound_ms"], k1_rows[E]["bound_by"]

    # ---- 3c. K2 on the same inputs ----
    k2_err, k2_t = k2_phase(cuda_inner_loop, pick_tile, cuda_ms, (f_s, pw, pwy, u0),
                            acc_k, acc_p, k1_tol, card)
    k2_ms = k2_t["ms"]
    print(f"K2 adapt_binary_tiled (tile {TILE}): kernel {k2_ms:.3f} ms against K1's "
          f"{k1_ms:.3f} ms; plain {k1_plain_ms:.3f} ms (the same function), bound "
          f"{k1_bound:.3f} ms ({k1_bound_by}, the same work), library_ms null [{card}]")

    # ---- 3d. K1 at shot 5 ----
    del f_s, pw, pwy, u0, acc_k, acc_p
    torch.cuda.empty_cache()
    k1_shot5 = k1_shot5_phase(cuda_inner_loop, binary_pixel_weights, cuda_ms,
                              np.random.default_rng(5), card)

    # ---- 3b. pivot kernels at the MMN path's shapes ----
    pivot = pivot_phase(cuda_pivot, cuda_ms, CenterPivotConv4d, card)

    # ---- 4. main path at full width ----
    cfg = load_cfg("configs/pascal.yaml")
    cfg = merge_cfg_from_list(cfg, ["cls_lr", str(CLS_LR), "episode_batch", str(E)])
    if (cfg.image_size, cfg.adapt_iter, cfg.layers) != (IMG, STEPS, 50):
        raise AssertionError("configs/pascal.yaml no longer gives the main path")
    engine = EpisodicEngine(cfg, device="cuda")
    w0 = engine.init_weights(E, torch.Generator().manual_seed(3))
    batch = engine.to_device(episodes)
    raw_norm = raw_init_witness(engine, batch, w0, cuda_inner_loop, binary_pixel_weights)
    # BN statistics from a synthetic calibration batch (other episodes than
    # the ones scored) so features have a trained network's scale, where the
    # 200-step inner loop is well-conditioned
    calib = make_episode_batch(11, E // 2, size=IMG, shot=SHOT)
    calib_images = torch.tensor(np.concatenate([calib["s_img"][:, 0], calib["q_img"]]),
                                device=dev)
    calibrate_batchnorm(engine.backbone, calib_images)

    cuda_inner_loop.reset_launches()
    masks = engine.serve_batch(episodes, w0=w0)
    metrics = engine.eval_metrics_batch(episodes, w0=w0)
    torch.cuda.synchronize()
    launches = dict(cuda_inner_loop.LAUNCHES)
    main_plan = cuda_inner_loop.LAST_PLAN["adapt_binary"]
    if launches["adapt_binary"] < 1 or main_plan is None:
        raise AssertionError("the main path did not launch the K1 kernel")
    print(f"main path launches: {launches}; the plan of K1's last launch on the main "
          f"path: grid {main_plan.grid} CTAs, {main_plan.ctas_per_group} CTAs per episode")
    if main_plan.ctas_per_group < 2:
        raise AssertionError(f"the main path's K1 runs an episode on one CTA: {main_plan}")
    if tuple(masks.shape) != (E, IMG, IMG):
        raise AssertionError(f"mask shape {tuple(masks.shape)}")
    if not set(masks.unique().tolist()) <= {0, 1}:
        raise AssertionError(f"mask values {masks.unique().tolist()}")
    for k in ("inter", "union", "inter0", "union0", "loss", "loss0"):
        if not torch.isfinite(metrics[k]).all():
            raise AssertionError(f"non-finite {k}")

    # the same episodes and inits through the plain inner loop, called directly
    with torch.no_grad():
        f_s_ep, f_q = engine._episode_features(batch)
        print(f"median per-pixel feature norm: raw init {raw_norm:.1f}, calibrated "
              f"{float(f_s_ep.norm(dim=-1).median()):.1f}")
        pw_ep, pwy_ep = binary_pixel_weights(batch["s_label"])
        acc = cuda_inner_loop.adapt_binary_reference(
            f_s_ep, pw_ep, pwy_ep, (w0[:, 1] - w0[:, 0]).contiguous(), STEPS, CLS_LR)
        w_plain = torch.stack([w0[:, 0] + CLS_LR * acc, w0[:, 1] - CLS_LR * acc], dim=1)
        pred_q, pred_q0 = engine._predict(f_q, w_plain)
        masks_plain = engine.mask_from_prediction(pred_q, (IMG, IMG))
        metrics_plain = engine.metrics_from_predictions(pred_q, pred_q0, batch)
    agree = float((masks == masks_plain).float().mean())
    fg_k = (metrics["inter"][:, 1] / metrics["union"][:, 1].clamp(min=1)).cpu().numpy()
    fg_p = (metrics_plain["inter"][:, 1] / metrics_plain["union"][:, 1].clamp(min=1)).cpu().numpy()
    print(f"kernel vs plain inner loop: mask agreement {agree:.6f} (>= 0.995 needed); "
          f"per-episode fg IoU kernel {np.round(fg_k, 4).tolist()} "
          f"plain {np.round(fg_p, 4).tolist()}")
    if agree < 0.995:
        raise AssertionError(f"mask agreement {agree} < 0.995")

    serve_s = host_seconds(lambda: engine.serve_batch(episodes, w0=w0), 3)
    eval_s = host_seconds(lambda: engine.eval_metrics_batch(episodes, w0=w0), 3)
    print(f"serve_batch: {E / serve_s:.3f} episodes/s ({serve_s * 1e3:.1f} ms per "
          f"batch of {E}); eval_metrics_batch: {E / eval_s:.3f} episodes/s "
          f"({eval_s * 1e3:.1f} ms per batch) [{card}; fp32, TF32 off, "
          f"1-shot, 473 px, adapt_iter {STEPS}]")

    # where a serve batch's device time goes, stage by stage
    with torch.no_grad():
        feat_ms = cuda_ms(lambda: engine._episode_features(batch), 3)
        loop_ms = cuda_ms(lambda: engine._adapted_episode(batch, w0), 1, warmup=0) - feat_ms
        tail_ms = cuda_ms(lambda: engine.mask_from_prediction(
            engine._predict(f_q, w_plain)[0], (IMG, IMG)), 3)
    print(f"serve batch of {E} by stage: backbone {feat_ms:.1f} ms, inner loop "
          f"(K1) {loop_ms:.1f} ms, CWT + prediction + 473 px tail {tail_ms:.1f} ms "
          f"[{card}]")

    # ---- 4b. CWT serve under the bf16 stage policies ----
    bf16_serve_phase(engine, episodes, w0, masks, card,
                                 (EpisodicEngine, cuda_inner_loop, cuda_ms))

    # ---- 5. the evaluation entry point ----
    tcfg = load_cfg("configs/pascal.yaml")
    tcfg = merge_cfg_from_list(tcfg, ["synthetic_data", "True", "test_num", "16",
                                      "n_runs", "1", "episode_batch", str(E)])
    lines = []
    miou = test_entry.main(tcfg, device="cuda", log=lines.append)
    miou_line = next(l for l in lines if l.startswith("mIoU---Val result"))
    print(f"train.test.main: {miou_line} (returned {miou:.4f}; random init, "
          "synthetic episodes)")
    if not np.isfinite(miou):
        raise AssertionError("entry point returned a non-finite mIoU")

    # ---- 6. MMN head: eval, serve and training at full width ----
    mmn_engine, mmn_eval_launches, mmn_train_launches = mmn_phase(
        card, calib_images, calib, cuda_ms, (
            load_cfg, merge_cfg_from_list, HeadEngine, make_episode_batch, cuda_inner_loop,
            cuda_pivot, adapt_classifier_batch, get_corr, build_optimizer, build_pspnet))

    # ---- 6b. the MMN train step at shot 5 ----
    mmn_shot5_phase(mmn_engine, card, (HeadEngine, cuda_inner_loop, cuda_pivot,
                                       build_optimizer))

    # ---- 6c. MMN options: meta_aug 2 with att_type 3, eval_episode_tile 2 ----
    mmn_options_phase(mmn_engine, card, (make_episode_batch, cuda_inner_loop, cuda_pivot))
    mmn_serve = (merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"),
                                     ["episode_batch", str(E_MMN)]),
                 {"backbone": module_state(mmn_engine.backbone),
                  "head": module_state(mmn_engine.head)},
                 make_episode_batch(13, E_MMN, size=IMG, shot=SHOT),
                 mmn_engine.init_weights(E_MMN, torch.Generator().manual_seed(5)))
    del mmn_engine
    torch.cuda.empty_cache()

    # ---- 6d. the match head: three routes, the pivot pair at 1 -> 10, cv4 ----
    match = match_phase(card, calib_images, calib, cuda_ms, (
        load_cfg, merge_cfg_from_list, HeadEngine, make_episode_batch, cuda_inner_loop,
        cuda_pivot, get_corr, build_pspnet, CenterPivotConv4d))
    torch.cuda.empty_cache()

    # ---- 7. the head trainer's entry point (flat route) ----
    hcfg = merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"), [
        "synthetic_data", "True", "epochs", "1", "iter_per_epoch", "8",
        "episode_batch", "2", "test_num", "8", "save_models", "False"])
    lines = []
    # the head trainers write results/ (log.txt, checkpoints) under the working
    # directory: run them in one of the smoke's own
    os.makedirs("build", exist_ok=True)
    run_dir = os.path.abspath(tempfile.mkdtemp(prefix="chip_smoke_head_", dir="build"))
    with contextlib.chdir(run_dir), pivot_route(True):
        best = train_head.main(hcfg, "mmn", device="cuda", log=lines.append)
    val_line = next(str(l) for l in lines if str(l).startswith("val: mIoU"))
    head_log = log_txt_val(os.path.join(run_dir, train_head.results_dir(hcfg, "mmn")),
                           "val: mIoU")
    print(f"train.train_head.main: {val_line} (best {best:.4f}; random init, synthetic "
          "episodes, 4 steps of 2 episodes, configs/pascal_mmn.yaml as shipped: use_amp); "
          f"its log.txt: {head_log}")
    if not np.isfinite(best):
        raise AssertionError("the head trainer returned a non-finite mIoU")
    kcfg = merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"), [
        "synthetic_data", "True", "shot", str(SHOT5), "epochs", "1", "iter_per_epoch", "2",
        "episode_batch", "1", "test_num", "2", "save_models", "False"])
    lines = []
    with contextlib.chdir(run_dir), pivot_route(True):
        best = train_kshot.main(kcfg, device="cuda", log=lines.append)
    shutil.rmtree(run_dir, ignore_errors=True)
    val_line = next(str(l) for l in lines if str(l).startswith("val: mIoU"))
    print(f"train.train_kshot.main (shot {SHOT5}, use_amp, 2 steps of 1 episode, test_num 2): "
          f"{val_line} (best {best:.4f})")
    if not np.isfinite(best):
        raise AssertionError("the k-shot trainer returned a non-finite mIoU")

    # ---- 8. CWT meta-train step at full width (calibrated engine of phase 4) ----
    train_counts, _ = cwt_train_phase(engine, episodes, w0, card, (
        cuda_inner_loop, binary_pixel_weights, build_optimizer))

    # ---- 8b. CWT at shot 5: eval, serve and the train step ----
    cwt_shot5_k1 = cwt_shot5_phase(engine, card, (EpisodicEngine, cuda_inner_loop,
                                                  binary_pixel_weights, build_optimizer))

    # ---- 8c. the fp32-vs-bf16 A/B tool ----
    ab_dtype_phase(engine, card)

    # ---- 9. the CWT trainer's entry point ----
    train_cwt_entry_phase(load_cfg, merge_cfg_from_list, train_cwt, test_entry,
                          trans_ckpt_dir)

    # ---- 10. real data: a PNG tree (cv2 and PIL blocked for pascal.yaml), the tools ----
    real = real_data_phase(card, (load_cfg, merge_cfg_from_list, cuda_inner_loop, cuda_pivot))

    # ---- 11. stage-1 pretraining, VGG and the bench ----
    cwt_state = {"backbone": module_state(engine.backbone), "cwt": module_state(engine.cwt)}
    del engine
    torch.cuda.empty_cache()
    pretrain_steps_phase(card, load_cfg)
    torch.cuda.empty_cache()
    pre = pretrain_entry_phase(card, (load_cfg, merge_cfg_from_list, cuda_inner_loop))
    vgg = vgg_phase(card, calib_images, (load_cfg, merge_cfg_from_list, EpisodicEngine,
                                         make_episode_batch, cuda_inner_loop,
                                         binary_pixel_weights, cuda_ms))
    torch.cuda.empty_cache()
    bench_phase(card)
    torch.cuda.empty_cache()

    # ---- 12. the tools: serve artifacts, the profiler trace ----
    tools = tools_phase(card, cwt_state, episodes, w0, mmn_serve, (
        load_cfg, merge_cfg_from_list, EpisodicEngine, HeadEngine))

    # ---- 13. scale-out: the dryrun's steps over processes, torchrun of two trainers ----
    torch.cuda.empty_cache()
    scale, scale_out = scale_out_phase(card, cwt_state, mmn_serve[1])
    torchrun_trainers_phase(card)

    main_block = pivot[(10, 10)]  # the heaviest consensus block stands for each kernel
    kernels = [{
        "name": "adapt_binary",
        "route": "cuda",
        "source": "few_shot_seg_cwt_tpu_torch/csrc/inner_loop.cu",
        "replaces": "few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py:37",
        "launches": launches["adapt_binary"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_bound_by,
        "library_ms": None,
        "dispatch": k1_dispatch,
        "real_data": {"launches": real["eval_launches"]["adapt_binary"]},
        "match": {"launches": match["eval_launches"]["adapt_binary"],
                  "train_match_launches": real["train_match_launches"]["adapt_binary"]},
        "pretrain_episodic_val": {"launches": pre["episodic"]["launches"]},
        "loaded_artifacts": {"cwt_launches": tools["cwt"]["launches"].get("adapt_binary", 0),
                             "mmn_launches": tools["mmn"]["launches"].get("adapt_binary", 0),
                             "profile_trace_kernels": tools["trace_k1"]},
        "vgg_30x30": vgg,
        "shot5": {"launches": cwt_shot5_k1, "max_abs_err": k1_shot5["err"],
                  "ms": k1_shot5["ms"], "plain_ms": k1_shot5["plain_ms"],
                  "bound_ms": k1_shot5["bound_ms"], "bound_by": k1_shot5["bound_by"]},
        "scale_out": {**scale_out["adapt_binary"],
                      "eval_launches_per_rank": [l["adapt_binary"]
                                                 for l in scale["eval_gathered"][0]["launches"]]},
    }, {
        "name": "adapt_binary_tiled",
        "route": "cuda",
        "source": "few_shot_seg_cwt_tpu_torch/csrc/inner_loop.cu",
        "replaces": "few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py:97",
        "launches": train_counts["K2"]["adapt_binary_tiled"],
        "real_data": {"launches": real["train_cwt_launches"]["adapt_binary_tiled"]},
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_bound_by,
        "library_ms": None,
        "dispatch": k2_t,
        "scale_out": scale_out["adapt_binary_tiled"],
    }, {
        "name": "pivot_fwd",
        "route": "cuda",
        "source": "few_shot_seg_cwt_tpu_torch/csrc/pivot.cu",
        "replaces": "few_shot_seg_cwt_tpu/ops/pallas_pivot_mxu.py:109",
        "also_replaces": "few_shot_seg_cwt_tpu/ops/pallas_pivot.py:106",
        "launches": mmn_eval_launches["pivot_fwd"],
        "real_data": {"launches": real["train_head_launches"]["pivot_fwd"]},
        "loaded_artifacts": {"mmn_launches": tools["mmn"]["launches"].get("pivot_fwd", 0)},
        "match_1_to_10": {"launches": match["eval_launches"]["pivot_fwd"],
                          "max_abs_err": match["ci1"]["fwd_err"], "ms": match["ci1"]["fwd_ms"],
                          "plain_ms": match["ci1"]["fwd_plain_ms"],
                          "bound_ms": match["ci1"]["bound_ms"],
                          "bound_by": match["ci1"]["bound_by"], "library_ms": None},
        "max_abs_err": main_block["fwd_err"],
        "ms": main_block["fwd_ms"],
        "plain_ms": main_block["fwd_plain_ms"],
        "bound_ms": main_block["bound_ms"],
        "bound_by": main_block["bound_by"],
        "library_ms": None,
        "dispatch": main_block["fwd_t"],
        "scale_out": scale_out["pivot_fwd"],
    }, {
        "name": "pivot_dw",
        "route": "cuda",
        "source": "few_shot_seg_cwt_tpu_torch/csrc/pivot.cu",
        "replaces": "few_shot_seg_cwt_tpu/ops/pallas_pivot_mxu.py:148",
        "also_replaces": "few_shot_seg_cwt_tpu/ops/pallas_pivot.py:165",
        "launches": mmn_train_launches["pivot_dw"],
        "real_data": {"launches": real["train_head_launches"]["pivot_dw"]},
        "match_1_to_10": {"launches": match["train_launches"]["pivot_dw"],
                          "max_abs_err": match["ci1"]["dw_err"], "ms": match["ci1"]["dw_ms"],
                          "plain_ms": match["ci1"]["dw_plain_ms"],
                          "bound_ms": match["ci1"]["bound_ms"],
                          "bound_by": match["ci1"]["bound_by"], "library_ms": None},
        "max_abs_err": main_block["dw_err"],
        "ms": main_block["dw_ms"],
        "plain_ms": main_block["dw_plain_ms"],
        "bound_ms": main_block["bound_ms"],
        "bound_by": main_block["bound_by"],
        "library_ms": None,
        "dispatch": main_block["dw_t"],
        "scale_out": scale_out["pivot_dw"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # run from the checkout's root whatever the caller's directory
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    sys.exit(main())
