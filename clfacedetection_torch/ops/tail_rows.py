"""The v1 tail's decisions: CUDA kernel and its plain twin.

From the node values of the v1 tail (``haar_tail``, or the ``"direct"``
strategy's stencil product), float32 ``[B, cap, n_clf * T]``, the
classifier votes (CART walks), the stage sums and the stage-tree path
test, in tail2's row format ``[B, cap, 4]``: vnf, alive, exit stage,
stage sum.  The JAX package computes this step in XLA on its TPU tail
kernel's output (``clfacedetection_tpu/detect/pyramid.py:922-944``, and
``:716-760`` in its XLA tail); it has no Pallas kernel of its own.

``tail_rows`` runs ``csrc/tail_rows.cu`` on CUDA tensors (float32 only)
and ``tail_rows_plain`` on CPU tensors; the two are bit-equal.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from .cascade_table import CascadeTable

__all__ = ["tail_rows", "tail_rows_plain"]

# float32 elements of one chunk of the plain version's vote tensors
_VOTE_CHUNK_ELEMS = 1 << 26
# stage trees the kernel takes: a path's stages are one 64-bit mask, and
# a slot keeps the sums of at most 32 leaf stages
_MAX_TREE_STAGES = 64
_MAX_LEAVES = 32


def clf_tensors(table: CascadeTable, c0: int, c1: int, device, dtype):
    """(thr, alpha, left, right) of classifiers ``c0..c1-1`` on
    ``device``, for ``_cart_votes``: thresholds [m, T] and leaves
    [m, T+1] in ``dtype``, links int64 [m, T]; made once
    (``CascadeTable.cached``)."""
    sl = slice(c0, c1)
    return table.cached(("clf", c0, c1, dtype), device, lambda: (
        torch.from_numpy(table.thr[sl]).to(device, dtype),
        torch.from_numpy(table.alpha[sl]).to(device, dtype),
        torch.from_numpy(table.left[sl]).to(device).long(),
        torch.from_numpy(table.right[sl]).to(device).long()))


def _group_tensors(table: CascadeTable, st: int, en: int, ca: int, device):
    """Stages ``st..en-1`` of a vote group whose first classifier is
    ``ca``: each stage's first classifier in the group and its classifier
    count, int64 [en - st] each; made once."""
    return table.cached(("group", st, en, ca), device, lambda: (
        torch.from_numpy(table.stage_clf0[st:en] - ca).to(device).long(),
        torch.from_numpy(table.stage_cnt[st:en]).to(device).long()))


def _path_tensors(table: CascadeTable, paths: List[List[int]], device):
    """The stage-tree paths for ``tail_rows_plain``: which stages lie off
    each path (bool [paths, S]) and each path's leaf stage (int64
    [paths]); made once per paths."""
    def make():
        pm = np.zeros((len(paths), table.n_stages), bool)
        for i, p in enumerate(paths):
            pm[i, p] = True
        leaf = np.array([p[-1] for p in paths], np.int64)
        return (torch.from_numpy(~pm).to(device),
                torch.from_numpy(leaf).to(device))
    return table.cached(("paths", repr(paths)), device, make)


def _cart_votes(nv: torch.Tensor, svnf: torch.Tensor, thr: torch.Tensor,
                alpha: torch.Tensor, left: torch.Tensor,
                right: torch.Tensor) -> torch.Tensor:
    """Classifier votes [..., m] from node values [..., m, T] of m
    classifiers with the tables of ``clf_tensors`` (JAX ``_cart_votes``,
    pyramid.py:68-116): ``cmp = node < thr * vnf`` with the product
    rounded first, then the walk from node 0 to the reached leaf's alpha.
    Padded nodes are never walked: links only point to a classifier's own
    later nodes."""
    m, T = nv.shape[-2:]
    dev, dtype = nv.device, nv.dtype
    cmp = nv < thr * svnf[..., None, None]
    rows = torch.arange(m, device=dev)
    if T == 1:                       # stumps: leaves alpha[-left/-right]
        a_l = alpha[rows, -left[:, 0]]
        a_r = alpha[rows, -right[:, 0]]
        return torch.where(cmp[..., 0], a_l, a_r)
    idx = torch.zeros(cmp.shape[:-1], dtype=torch.long, device=dev)
    val = torch.zeros(cmp.shape[:-1], dtype=dtype, device=dev)
    done = torch.zeros(cmp.shape[:-1], dtype=torch.bool, device=dev)
    for _ in range(T):
        c = cmp.gather(-1, idx[..., None])[..., 0]
        nxt = torch.where(c, left[rows, idx], right[rows, idx])
        leaf = nxt <= 0
        av = alpha[rows, (-nxt).clamp(0, T)]
        val = torch.where(leaf & ~done, av, val)
        done = done | leaf
        idx = nxt.clamp(0, T - 1)
    return val


def tail_rows_plain(values: torch.Tensor, svnf: torch.Tensor,
                    surv_idx: torch.Tensor, n: int, table: CascadeTable,
                    front_k: int, paths: Optional[List[List[int]]] = None
                    ) -> torch.Tensor:
    """The v1 tail's decisions from its node values [B, cap, n_clf*T], in
    tail2's row format [B, cap, 4]: vnf, alive, exit stage, stage sum.
    Slots whose index in ``surv_idx`` lies outside ``[0, n)`` are padding.

    Its tables come from the table's cache (``CascadeTable.cached``), so
    a run copies nothing from the host once they are made.

    Stage sums are sequential in classifier order (the front's order, so
    front and tail agree, and the card and the CPU agree bit for bit).
    Sequential cascades (``paths=None``) evaluate stages
    ``front_k..S-1``: alive = all pass, exit stage = the first failing one
    (S on a pass), stage sum = that stage's.  Stage trees evaluate every
    stage and accept when any root-to-leaf path passes all its stages
    (``_tail_accept_chunk``, pyramid.py:725-749): exit stage S on accept
    and 0 otherwise, stage sum = the first passing path's leaf stage.  Pad
    slots give (0, 0, S, 0)."""
    valid = (surv_idx >= 0) & (surv_idx < n)
    B, cap = valid.shape
    S, T, dev = table.n_stages, table.T, values.device
    dtype = svnf.dtype
    s_lo = 0 if paths is not None else min(front_k, S)
    ns = S - s_lo
    if ns == 0:
        alive = valid
        level = torch.full_like(svnf, float(S))
        weight = torch.zeros_like(svnf)
    else:
        # stages in groups whose votes fit one chunk (a group holds at
        # least one stage), so no [B, cap, n_clf] vote tensor is built
        ssum = torch.empty((B, cap, ns), dtype=dtype, device=dev)
        step = max(1, _VOTE_CHUNK_ELEMS // max(1, B * cap * T))
        c0s, cnts = table.stage_clf0, table.stage_cnt
        st = s_lo
        while st < S:
            en = st + 1
            while en < S and c0s[en] + cnts[en] - c0s[st] <= step:
                en += 1
            ca, cb = int(c0s[st]), int(c0s[en - 1] + cnts[en - 1])
            nv = values[:, :, ca * T:cb * T].reshape(B, cap, cb - ca, T)
            votes = _cart_votes(nv.to(dtype), svnf,
                                *clf_tensors(table, ca, cb, dev, dtype))
            ofs, cnt = _group_tensors(table, st, en, ca, dev)
            g = torch.zeros((B, cap, en - st), dtype=dtype, device=dev)
            for j in range(int(cnts[st:en].max())):
                v = votes.index_select(2, (ofs + j).clamp(max=cb - ca - 1))
                g = torch.where(j < cnt, g + v, g)
            ssum[:, :, st - s_lo:en - s_lo] = g
            del votes, nv
            st = en
        del values
        thr = table.cached(
            ("stage_thr", s_lo, dtype), dev,
            lambda: torch.from_numpy(table.stage_thr[s_lo:]).to(dev, dtype))
        st_pass = ssum >= thr                                # [B, cap, ns]
        if paths is None:
            fail = ~st_pass
            alive = valid & ~fail.any(dim=2)
            first = fail.to(torch.uint8).argmax(dim=2)
            level = torch.where(fail.any(dim=2), (first + s_lo).to(dtype),
                                float(S))
            widx = torch.where(fail.any(dim=2), first, ns - 1)
        else:
            off_path, leaf = _path_tensors(table, paths, dev)
            per_path = (st_pass[:, :, None, :] | off_path).all(dim=3)
            accept = per_path.any(dim=2)
            alive = valid & accept
            widx = leaf[per_path.to(torch.uint8).argmax(dim=2)]
            level = torch.where(accept, float(S), 0.0).to(dtype)
        weight = ssum.gather(2, widx[..., None])[..., 0]
    return torch.stack([torch.where(valid, svnf, 0.0), alive.to(dtype),
                        torch.where(valid, level, float(S)),
                        torch.where(valid, weight, 0.0)], dim=-1)


def _path_buffer(table: CascadeTable, paths: List[List[int]], device):
    """The stage-tree paths for the kernel, int32: per path its stages as
    a 64-bit mask (low, high word), the index of its leaf stage among the
    distinct leaf stages, 0; then per stage its leaf index (-1 for a
    stage that ends no path).  Copied once per device and paths."""
    def make():
        leaves = sorted({p[-1] for p in paths})
        rec = np.zeros((len(paths), 4), np.uint32)
        for i, p in enumerate(paths):
            mask = sum(1 << s for s in p)
            rec[i, 0], rec[i, 1] = mask & 0xFFFFFFFF, mask >> 32
            rec[i, 2] = leaves.index(p[-1])
        of_stage = np.full(table.n_stages, -1, np.int32)
        of_stage[leaves] = np.arange(len(leaves))
        return torch.from_numpy(np.concatenate(
            [rec.view(np.int32).reshape(-1), of_stage])).to(device)
    return table.cached(("path_buffer", repr(paths)), device, make)


def tail_rows(values: torch.Tensor, svnf: torch.Tensor,
              surv_idx: torch.Tensor, n: int, table: CascadeTable,
              front_k: int, paths: Optional[List[List[int]]] = None
              ) -> torch.Tensor:
    """Rows [B, cap, 4] (vnf, alive, exit stage, stage sum) from node
    values ``values`` [B, cap, n_clf*T], the survivors' vnf ``svnf``
    [B, cap] and their slot indices ``surv_idx`` (int32 [B, cap]; outside
    ``[0, n)`` is padding).  ``paths`` (stage trees only) are the
    root-to-leaf stage chains.  CPU tensors run ``tail_rows_plain``; CUDA
    tensors launch the kernel (float32 only)."""
    if values.ndim != 3 or svnf.shape != values.shape[:2] \
            or surv_idx.shape != values.shape[:2]:
        raise ValueError("values must be [B, cap, nodes], svnf and "
                         "surv_idx [B, cap]")
    if values.shape[2] != table.n_clf * table.T:
        raise ValueError(f"values hold {values.shape[2]} nodes, the table "
                         f"{table.n_clf * table.T}")
    if surv_idx.dtype != torch.int32:
        raise ValueError("surv_idx must be int32")
    if values.device != svnf.device or values.device != surv_idx.device:
        raise ValueError("values, svnf and surv_idx must lie on one device")
    if values.device.type == "cpu":
        return tail_rows_plain(values, svnf, surv_idx, n, table, front_k,
                               paths)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.float32 or svnf.dtype != torch.float32:
        raise NotImplementedError("the CUDA decisions run in float32 only")
    if not (values.is_contiguous() and svnf.is_contiguous()
            and surv_idx.is_contiguous()):
        raise ValueError("values, svnf and surv_idx must be contiguous")
    S = table.n_stages
    n_leaves = len({p[-1] for p in paths}) if paths is not None else 0
    if paths is not None and (S > _MAX_TREE_STAGES
                              or n_leaves > _MAX_LEAVES):
        raise NotImplementedError(
            f"stage trees of {S} stages or more than {_MAX_LEAVES} leaf "
            f"stages: the kernel takes at most {_MAX_TREE_STAGES} stages")
    B, cap, nn = values.shape
    dev = values.device
    out = torch.empty((B, cap, 4), dtype=torch.float32, device=dev)
    tab = table.device_buffer(dev, rows=True)
    pb = _path_buffer(table, paths, dev) if paths is not None else None
    with kernels.on_device(dev):
        err = kernels.lib().clfd_tail_rows(
            values.data_ptr(), svnf.data_ptr(), surv_idx.data_ptr(),
            tab.data_ptr(), pb.data_ptr() if pb is not None else None,
            out.data_ptr(), B, cap, nn, n, S, table.T,
            0 if paths is not None else min(front_k, S),
            len(paths) if paths is not None else 0, n_leaves,
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("clfd_tail_rows", err)
    kernels.count(tail_rows)
    return out
