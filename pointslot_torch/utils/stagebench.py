"""Prefix stage timing of the stereo frontend and of the mode-4 step.

Port of ``pointslot_tpu/utils/stagebench.py``. Timing each stage as a call
of its own charges it what its inputs cost to make; timing PREFIXES of the
real pipeline instead, each built from the same pieces the shipped program
runs, gives each stage's marginal cost as the difference of two successive
prefixes. The prefix names and their order are the reference's.

Each prefix reduces its outputs to a scalar tensor. ``timeit_ms`` times a
prefix between CUDA events on the card and on the host clock on the CPU,
with the reference's two-point calibration; where the signal stays inside
the noise it returns None (the reference returns NaN, which ``json.dumps``
writes as a bare ``NaN``), and the stage-ms functions leave that stage out.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import torch


def frontend_prefixes(fe) -> dict:
    """Ordered {name: (left, right) -> scalar} prefixes of the single-pair
    frontend (``StereoFrontend._frontend``): the stacked (2, h, w) image
    stage and selection, then the two per-image patch gathers, then
    orientation, blur and BRIEF, then the whole frontend (stereo match, SAD
    and fine refine added). left, right: (H, W) tensors on the frontend's
    device."""
    from pointslot_torch.ops.patch import gather_patches

    ext = fe.extractor

    def image_stage(left, right):
        both = torch.stack([left.to(torch.float32), right.to(torch.float32)])
        levels, scores = fe._image_stage(both)
        xyl, _, top, _, _ = ext.detect(scores)
        return levels, xyl, top

    def p_select(left, right):
        _, xyl, top = image_stage(left, right)
        return xyl.sum() + top.sum()

    def patches_of(levels, xyl, g):
        return gather_patches([x[g] for x in levels], xyl[g])

    def p_patch(left, right):
        levels, xyl, _ = image_stage(left, right)
        return patches_of(levels, xyl, 0).sum() + patches_of(levels, xyl, 1).sum()

    def p_brief(left, right):
        levels, xyl, _ = image_stage(left, right)
        out = []
        for g in range(2):
            pat = patches_of(levels, xyl, g)
            ang = ext._orientation_from_patches(pat)
            out.append(ext._descriptors_from_patches(ext._blur_patches(pat), ang))
        return out[0].sum() + out[1].sum()

    def p_full(left, right):
        sf = fe.run(left, right)
        return torch.sum(sf.xy) + torch.sum(sf.depth)

    return {
        "pyr_fast_select": p_select,
        "patch_dma": p_patch,
        "orient_brief": p_brief,
        "stereo_sad": p_full,
    }


def track_prefixes(step, phase) -> dict:
    """Ordered prefixes of the mode-4 step beyond the frontend: the motion
    model match, the first pose LM, the local-map match, the second pose
    LM, then the batched object phase, built from the port's
    ``FusedTrackStep`` / ``FusedObjectPhase`` stages. Each takes (left,
    right, map_pos, map_desc, map_level, map_valid, obj_pos, obj_desc,
    obj_valid, T_obj) device tensors and returns a scalar; T_prev and the
    velocity are the identity."""
    fe = step.frontend

    def stages(left, right, pos, dsc, lvl, val, upto):
        frame = fe.run(left, right)
        acc = torch.sum(frame.xy) + torch.sum(frame.depth)
        T_pred = torch.eye(4, device=pos.device)
        if upto == 0:
            return acc, frame, T_pred
        pf1 = step._match_stage(frame, T_pred, pos, dsc, lvl, val, radius=7.0)
        if upto == 1:
            return acc + torch.sum(pf1), frame, T_pred
        T1, _, _ = step._solve_stage(frame, pf1, T_pred, pos)
        if upto == 2:
            return acc + torch.sum(T1), frame, T1
        pf2 = step._match_stage(frame, T1, pos, dsc, lvl, val, radius=4.0)
        pf = torch.where(pf2 >= 0, pf2, pf1)
        if upto == 3:
            return acc + torch.sum(pf), frame, T1
        T2, _, n_inliers = step._solve_stage(frame, pf, T1, pos)
        return acc + torch.sum(T2) + n_inliers.to(torch.float32), frame, T2

    def make(upto):
        def p(left, right, pos, dsc, lvl, val, opos, odesc, ovalid, oT):
            return stages(left, right, pos, dsc, lvl, val, upto)[0]
        return p

    def p_object(left, right, pos, dsc, lvl, val, opos, odesc, ovalid, oT):
        acc, frame, _ = stages(left, right, pos, dsc, lvl, val, 4)
        ovel = torch.eye(4, device=oT.device).expand(oT.shape[0], 4, 4)
        T_new, _, n_inl = phase.run(frame.xy, frame.level, frame.desc, frame.valid,
                                    frame.depth, frame.u_right, opos, odesc, ovalid, oT, ovel)
        return acc + torch.sum(T_new) + torch.sum(n_inl).to(torch.float32)

    return {
        "frontend": make(0),
        "cam_match1": make(1),
        "cam_lm1": make(2),
        "cam_match2": make(3),
        "cam_lm2": make(4),
        "object_phase": p_object,
    }


def _marginal(absolute: dict) -> dict:
    """Successive prefix deltas (the first entry absolute). A prefix without
    a time, or whose predecessor has none, is left out."""
    names = list(absolute)
    out = {}
    if absolute[names[0]] is not None:
        out[names[0]] = absolute[names[0]]
    for a, b in zip(names, names[1:]):
        if absolute[a] is not None and absolute[b] is not None:
            out[b] = max(absolute[b] - absolute[a], 0.0)
    return out


def track_stage_ms(step, phase, left, right, map_tables, obj_tables, n=30) -> dict:
    """Marginal ms of each post-frontend tracking stage (successive prefix
    deltas; 'frontend' is its prefix's absolute time)."""
    prefixes = track_prefixes(step, phase)
    args = (left, right) + tuple(map_tables) + tuple(obj_tables)
    return _marginal({k: timeit_ms(fn, *args, n=n) for k, fn in prefixes.items()})


def _run_timed(fn, args, steps: int) -> float:
    """Seconds for `steps` calls of fn(*args) in a row: between CUDA events
    on the card (device time, the host's launch gaps included), on the host
    clock on the CPU."""
    dev = next((a.device for a in args if torch.is_tensor(a)), torch.device("cpu"))
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    return time.perf_counter() - t0


def timeit_ms(fn, *args, n=30, warmup=3, max_escalations=2) -> Optional[float]:
    """ms per call of a scalar-returning fn, by the reference's two-point
    calibration: the chain of n and of 3n calls, each timed twice, gives
    (T(3n) - T(n)) / 2n, which cancels the fixed cost of a timed run. When
    that signal is within the noise (the spread of the repeats) n grows 3x,
    up to ``max_escalations`` times; if it never clears the noise a warning
    is raised and None is returned."""
    for _ in range(warmup):
        fn(*args)

    def once(steps):
        return _run_timed(fn, args, steps)

    signal = 0.0
    for _ in range(max_escalations + 1):
        t1a, t1b = once(n), once(n)
        t3a, t3b = once(3 * n), once(3 * n)
        signal = min(t3a, t3b) - min(t1a, t1b)
        noise = max(abs(t1a - t1b), abs(t3a - t3b))
        if signal > 2.0 * noise:
            return signal / (2 * n) * 1e3
        n *= 3
    warnings.warn(f"timeit_ms: signal {signal * 1e3:.4f} ms within the noise even at "
                  f"n={n // 3}; no time reported", stacklevel=2)
    return None


def frontend_stage_ms(fe, left, right, n=30) -> dict:
    """Marginal ms of each frontend stage (successive prefix deltas; the
    first entry is its prefix's absolute time)."""
    prefixes = frontend_prefixes(fe)
    return _marginal({k: timeit_ms(fn, left, right, n=n) for k, fn in prefixes.items()})
