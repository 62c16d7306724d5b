"""The v1 route's tail in one walk: CUDA kernel and its plain twin.

For every survivor slot (a flat canvas index, or a pad value outside
``[0, Hv*Wv)``) the cascade's stages from ``front_k`` on, walked from the
integral planes, in tail2's row format float32 ``[B, cap, 4]``: vnf,
alive, exit stage, stage sum.  It computes what ``tail_rows`` computes on
``haar_tail``'s node values (``ops/tail_rows.py``, ``ops/haar_tail.py``),
bit for bit, without those values: a node is evaluated where its
classifier's walk reaches it, and a stage only for the survivors that
enter it (a sequential cascade's survivors until their first failing
stage; a stage tree's where the stage is a root or its parent passed, and
path 0's leaf always).  The JAX package computes the node values as a
stencil product in its TPU tail kernel
(``clfacedetection_tpu/ops/haar_tail.py:116``) and the decisions in XLA
on them (``clfacedetection_tpu/detect/pyramid.py:915-944``).

``tail_walk`` runs ``csrc/tail_walk.cu`` on CUDA tensors (float32 only)
and ``tail_walk_plain`` on CPU tensors; the two are bit-equal.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from .cascade_table import CascadeTable
from .haar_tail import patch_shape
from .tail_rows import (_MAX_LEAVES, _MAX_TREE_STAGES, _cart_votes,
                        _path_buffer, _path_tensors, clf_tensors)

__all__ = ["tail_walk", "tail_walk_plain", "walk_plan"]

# int64 elements of one chunk of the plain version's corner indices
# (a chunk is a stage's classifiers at every window walked)
_CHUNK_ELEMS = 1 << 24


def walk_plan(table: CascadeTable, front_k: int,
              paths: Optional[List[List[int]]] = None):
    """(first stage walked, each stage's parent, path 0's leaf stage).

    A sequential cascade walks from ``min(front_k, S)``; its parents are
    None and its leaf -1.  A stage tree walks from ``front_k`` where
    stages ``0..front_k-1`` lie on every path and end none (the front's
    common prefix, which every survivor passed), else from 0; each
    stage's parent is the stage before it on its paths (-1 for a root),
    and a parent must come before its stage."""
    S = table.n_stages
    if paths is None:
        return min(front_k, S), None, -1
    parents = np.full(S, -2, np.int32)
    for p in paths:
        for i, st in enumerate(p):
            par = p[i - 1] if i else -1
            if parents[st] not in (-2, par):
                raise ValueError(f"stage {st} has two parents")
            parents[st] = par
    if (parents == -2).any():
        raise ValueError("a stage lies on no root-to-leaf path")
    late = np.nonzero(parents >= np.arange(S))[0]
    if len(late):
        raise ValueError(f"stage {int(late[0])}'s parent "
                         f"{int(parents[late[0]])} does not come before it")
    s_lo = min(front_k, S)
    prefix = set(range(s_lo))
    if any(not prefix <= set(p) or p[-1] < s_lo for p in paths):
        s_lo = 0
    return s_lo, parents, paths[0][-1]


def _stage_tensors(table: CascadeTable, st: int, wp: int, tilt_ofs: int,
                   device, dtype):
    """Stage ``st``'s nodes for ``tail_walk_plain``, made once
    (``CascadeTable.cached``): each rect corner's offset into the flat
    planes from a window's top-left ``sum`` entry (int64 [cnt*T*12]; a
    tilted node's corners ``tilt_ofs`` further, in the tilted plane), the
    weights [cnt, T, 3] in ``dtype`` and the rect counts [cnt, T]."""
    def make():
        sl = slice(int(table.stage_clf0[st]),
                   int(table.stage_clf0[st] + table.stage_cnt[st]))
        cor = table.corners[sl].astype(np.int64)       # [cnt, T, 3, 4, 2]
        off = cor[..., 0] * wp + cor[..., 1] \
            + table.tilted[sl][..., None, None] * tilt_ofs
        return (torch.from_numpy(off.reshape(-1)).to(device),
                torch.from_numpy(table.weights[sl]).to(device, dtype),
                torch.from_numpy(table.n_rects[sl]).to(device))
    return table.cached(("walk", st, wp, tilt_ofs, dtype), device, make)


def _stage_sums(flat, base, svnf, table, st, wp, tilt_ofs):
    """Stage ``st``'s sums at the windows whose top-left entries of the
    flat planes are ``base`` [R], its classifiers in chunks: node values
    as ``tail_values_plain`` takes them, votes by ``_cart_votes``, the sum
    in classifier order from 0."""
    dtype, dev = svnf.dtype, svnf.device
    c0, cnt = int(table.stage_clf0[st]), int(table.stage_cnt[st])
    off, w, has = _stage_tensors(table, st, wp, tilt_ofs, dev, dtype)
    thr, alpha, left, right = clf_tensors(table, c0, c0 + cnt, dev, dtype)
    R, T = base.shape[0], table.T
    ssum = torch.zeros(R, dtype=dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // max(1, R * T * 12))
    for a in range(0, cnt, step):
        b = min(cnt, a + step)
        g = flat[base[:, None] + off[a * T * 12:b * T * 12]].reshape(
            R, b - a, T, 3, 4)
        rs = (g[..., 0] - g[..., 1] - g[..., 2] + g[..., 3]).to(dtype)
        terms = rs * w[a:b]
        nv = terms[..., 0]
        for k in (1, 2):
            nv = torch.where(has[a:b] > k, nv + terms[..., k], nv)
        votes = _cart_votes(nv, svnf, thr[a:b], alpha[a:b], left[a:b],
                            right[a:b])                   # [R, b - a]
        for j in range(b - a):
            ssum = ssum + votes[:, j]
    return ssum


def tail_walk_plain(sum_: torch.Tensor, tilted: Optional[torch.Tensor],
                    svnf: torch.Tensor, surv_idx: torch.Tensor, hv: int,
                    wv: int, table: CascadeTable, front_k: int,
                    paths: Optional[List[List[int]]] = None,
                    masked: Optional[bool] = None) -> torch.Tensor:
    """[B, cap, 4] rows (vnf, alive, exit stage, stage sum) in the dtype
    of ``svnf``, stage by stage over the slots that enter each stage.

    On the CPU a stage runs over those slots alone and the walk ends
    where none is left.  ``masked`` (the default on a CUDA device: float64
    and the plain path) runs each stage over every slot and keeps the
    entering ones by a mask, so that the walk has no data-dependent shape
    and a CUDA graph can hold it; the rows are the same.  Its tables come
    from the table's cache."""
    B, cap = surv_idx.shape
    _, hp, wp = sum_.shape
    dtype, dev = svnf.dtype, sum_.device
    S = table.n_stages
    s_lo, parents, leaf0 = walk_plan(table, front_k, paths)
    n = hv * wv
    valid = (surv_idx >= 0) & (surv_idx < n)
    idx = torch.where(valid, surv_idx, 0).long()
    y = torch.div(idx, wv, rounding_mode="floor")
    base = (torch.arange(B, device=dev)[:, None] * (hp * wp) + y * wp
            + idx - y * wv).reshape(-1)
    if table.has_tilted:
        flat = torch.cat([sum_.reshape(-1), tilted.reshape(-1)])
        tilt_ofs = B * hp * wp
    else:
        flat, tilt_ofs = sum_.reshape(-1), 0
    ok = valid.reshape(-1)
    vnf = svnf.reshape(-1)
    N = ok.shape[0]
    level = torch.full((N,), float(S), dtype=dtype, device=dev)
    weight = torch.zeros(N, dtype=dtype, device=dev)
    alive = ok.clone()
    if paths is not None:
        passed = torch.zeros((N, S), dtype=torch.bool, device=dev)
        passed[:, :s_lo] = True
        sums = torch.zeros((N, S), dtype=dtype, device=dev)
        leaves = {p[-1] for p in paths}
    if masked is None:
        masked = dev.type != "cpu"
    every = torch.arange(N, device=dev) if masked else None
    for st in range(s_lo, S):
        if paths is None:
            enter = alive
        elif parents[st] < 0 or st == leaf0:
            enter = ok
        else:
            enter = ok & passed[:, int(parents[st])]
        if every is None:
            rows = enter.nonzero()[:, 0]
            if rows.numel() == 0:
                if paths is None:
                    break
                continue
        else:
            rows = every
        sel = enter[rows]
        ssum = _stage_sums(flat, base[rows], vnf[rows], table, st, wp,
                           tilt_ofs)
        pass_ = ssum >= float(table.stage_thr[st])   # exact in either dtype
        if paths is None:
            stop = sel & (~pass_ | (st == S - 1))
            level[rows] = torch.where(sel & ~pass_, float(st), level[rows])
            weight[rows] = torch.where(stop, ssum, weight[rows])
            alive[rows] = sel & pass_
        else:
            passed[rows, st] = sel & pass_
            if st in leaves:
                sums[rows, st] = torch.where(sel, ssum, sums[rows, st])
    if paths is not None:
        off_path, leaf = _path_tensors(table, paths, dev)
        per_path = (passed[:, None, :] | off_path).all(dim=2)   # [N, P]
        accept = per_path.any(dim=1)
        first = leaf[per_path.to(torch.uint8).argmax(dim=1)]
        weight = sums.gather(1, first[:, None])[:, 0]
        level = torch.where(accept, float(S), 0.0).to(dtype)
        alive = ok & accept
    rows = torch.stack([torch.where(ok, vnf, 0.0), alive.to(dtype),
                        torch.where(ok, level, float(S)),
                        torch.where(ok, weight, 0.0)], dim=-1)
    return rows.reshape(B, cap, 4)


def tail_walk(sum_: torch.Tensor, tilted: Optional[torch.Tensor],
              svnf: torch.Tensor, surv_idx: torch.Tensor, hv: int, wv: int,
              table: CascadeTable, front_k: int,
              paths: Optional[List[List[int]]] = None) -> torch.Tensor:
    """Rows [B, cap, 4] (vnf, alive, exit stage, stage sum) for survivor
    slots ``surv_idx`` (int32 [B, cap]; outside ``[0, hv*wv)`` is padding)
    on the [B, Hp, Wp] ``sum`` (and ``tilted``) planes, with the
    survivors' vnf ``svnf`` [B, cap].  ``paths`` (stage trees only) are
    the root-to-leaf stage chains.  Survivors must have passed stages
    ``0..front_k-1`` (the front's).  CPU tensors run ``tail_walk_plain``;
    CUDA tensors launch the kernel (float32 only)."""
    planes = (sum_,) + ((tilted,) if table.has_tilted else ())
    if table.has_tilted and tilted is None:
        raise ValueError("the cascade has tilted features: pass the tilted "
                         "plane")
    if any(p.dtype != torch.int32 or p.ndim != 3 or not p.is_contiguous()
           or p.shape != sum_.shape or p.device != sum_.device
           for p in planes):
        raise ValueError("planes must be contiguous int32 [B, Hp, Wp] "
                         "tensors of one shape on one device")
    if surv_idx.dtype != torch.int32 or surv_idx.ndim != 2 \
            or not surv_idx.is_contiguous() \
            or surv_idx.shape[0] != sum_.shape[0] \
            or surv_idx.device != sum_.device:
        raise ValueError("surv_idx must be a contiguous int32 [B, cap] "
                         "tensor on the planes' device")
    if svnf.shape != surv_idx.shape or not svnf.is_contiguous() \
            or svnf.device != sum_.device:
        raise ValueError("svnf must be a contiguous [B, cap] tensor on the "
                         "planes' device")
    B, hp, wp = sum_.shape
    if hp < hv + table.max_dy or wp < wv + table.max_dx:
        raise ValueError(f"planes {hp}x{wp} too small for a {hv}x{wv} "
                         f"grid plus the window")
    if not 0 <= front_k <= table.n_stages:
        raise ValueError(f"front_k {front_k} outside [0, {table.n_stages}]")
    if sum_.device.type == "cpu":
        return tail_walk_plain(sum_, tilted, svnf, surv_idx, hv, wv, table,
                               front_k, paths)
    if sum_.device.type != "cuda":
        raise ValueError(f"unsupported device {sum_.device}")
    if svnf.dtype != torch.float32:
        raise NotImplementedError("the CUDA walk runs in float32 only")
    S = table.n_stages
    s_lo, parents, leaf0 = walk_plan(table, front_k, paths)
    n_leaves = len({p[-1] for p in paths}) if paths is not None else 0
    if paths is not None and (S > _MAX_TREE_STAGES
                              or n_leaves > _MAX_LEAVES):
        raise NotImplementedError(
            f"stage trees of {S} stages or more than {_MAX_LEAVES} leaf "
            f"stages: the kernel takes at most {_MAX_TREE_STAGES} stages")
    dev = sum_.device
    cap = surv_idx.shape[1]
    ph, pw = patch_shape(table)
    out = torch.empty((B, cap, 4), dtype=torch.float32, device=dev)
    tab = table.device_buffer(dev)
    pb = par = None
    if paths is not None:
        pb = _path_buffer(table, paths, dev)
        par = table.cached(("walk_parents", repr(paths)), dev,
                           lambda: torch.from_numpy(parents).to(dev))
    with kernels.on_device(dev):
        err = kernels.lib().clfd_tail_walk(
            sum_.data_ptr(), tilted.data_ptr() if table.has_tilted else None,
            svnf.data_ptr(), surv_idx.data_ptr(), tab.data_ptr(),
            pb.data_ptr() if pb is not None else None,
            par.data_ptr() if par is not None else None, out.data_ptr(),
            B, hv, wv, hp, wp, cap, S, table.clf_words, s_lo,
            len(paths) if paths is not None else 0, n_leaves, leaf0, ph, pw,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("clfd_tail_walk", err)
    kernels.count(tail_walk)
    return out
