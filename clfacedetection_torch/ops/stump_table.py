"""The cascade at scale 1, packed for the front and tail kernels.

A stump cascade with upright features is, per node, up to three weighted
rects plus a threshold and two leaf values, and per stage a node range
and a threshold.  ``StumpTable`` holds those as numpy arrays (read by the
plain PyTorch versions) and as ONE int32 buffer (read by the CUDA
kernels), so both read the same numbers.  The buffer layout is defined
here and in ``csrc/cascade.cuh``:

* stages, ``STAGE_WORDS`` each: first node, node count, threshold (f32
  bits), 0;
* then nodes, ``NODE_WORDS`` each: rect count; 3 x (ya, xa, yb, xb) rect
  corners; 3 weights, threshold, left leaf, right leaf (f32 bits); 0.

An upright rect's four corners are (ya, xa) (ya, xb) (yb, xa) (yb, xb)
with signs + - - +.  Rects of weight 0 are left out, as the JAX
package's front skips them; the rest keep their order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..detect.detector import _ClfTables
from ..models.compile import CompiledCascade

__all__ = ["StumpTable", "STAGE_WORDS", "NODE_WORDS"]

STAGE_WORDS = 4
NODE_WORDS = 20


@dataclasses.dataclass
class StumpTable:
    stage_node0: np.ndarray   # int32 [S]
    stage_cnt: np.ndarray     # int32 [S]
    stage_thr: np.ndarray     # float32 [S] (bias applied)
    n_rects: np.ndarray       # int32 [N]
    rects: np.ndarray         # int32 [N, 3, 4] (ya, xa, yb, xb)
    weights: np.ndarray       # float32 [N, 3]
    thr: np.ndarray           # float32 [N]
    a_left: np.ndarray        # float32 [N]
    a_right: np.ndarray       # float32 [N]
    equ: tuple                # (ya, xa, yb, xb) of the variance rect
    inv_area: float           # 1 / area of the variance rect
    max_dy: int               # largest corner row offset
    max_dx: int               # largest corner column offset
    packed: np.ndarray        # int32 [S*STAGE_WORDS + N*NODE_WORDS]
    _dev: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return int(self.stage_cnt.shape[0])

    @classmethod
    def build(cls, c: CompiledCascade, tables: _ClfTables,
              equ_y, equ_x, inv_area: float) -> "StumpTable":
        """Pack the scale-1 tables (``_build_clf_tables(c, [1.0])``)."""
        if tables.T != 1 or c.has_tilted:
            raise NotImplementedError(
                "StumpTable packs stump cascades with upright features")
        spec = c.spec
        n = tables.n_clf
        cy, cx, w = tables.corner_y[0, :, 0], tables.corner_x[0, :, 0], \
            tables.weight[0, :, 0]            # [N, 3, 4], [N, 3]
        rects = np.zeros((n, 3, 4), np.int32)
        weights = np.zeros((n, 3), np.float32)
        n_rects = np.zeros(n, np.int32)
        for i in range(n):
            for k in range(3):
                if w[i, k] == 0.0:
                    continue
                ys, xs = cy[i, k], cx[i, k]
                if not (ys[0] == ys[1] and ys[2] == ys[3]
                        and xs[0] == xs[2] and xs[1] == xs[3]):
                    raise ValueError(f"node {i} rect {k} is not upright")
                j = n_rects[i]
                rects[i, j] = (ys[0], xs[0], ys[2], xs[1])
                weights[i, j] = w[i, k]
                n_rects[i] += 1
        alpha = tables.alpha
        idx = np.arange(n)
        a_l = alpha[idx, -tables.left[:, 0]].astype(np.float32)
        a_r = alpha[idx, -tables.right[:, 0]].astype(np.float32)
        thr = tables.threshold[:, 0].astype(np.float32)
        s_n0 = spec.stage_clf_ofs.astype(np.int32)
        s_cnt = spec.stage_clf_cnt.astype(np.int32)
        s_thr = np.asarray(c.stage_threshold, np.float32)
        equ = (int(equ_y[0]), int(equ_x[0]), int(equ_y[2]), int(equ_x[1]))

        S = len(s_cnt)
        st = np.zeros((S, STAGE_WORDS), np.int32)
        st[:, 0], st[:, 1] = s_n0, s_cnt
        st[:, 2] = s_thr.view(np.int32)
        nd = np.zeros((n, NODE_WORDS), np.int32)
        nd[:, 0] = n_rects
        nd[:, 1:13] = rects.reshape(n, 12)
        nd[:, 13:16] = weights.view(np.int32)
        nd[:, 16] = thr.view(np.int32)
        nd[:, 17] = a_l.view(np.int32)
        nd[:, 18] = a_r.view(np.int32)
        packed = np.concatenate([st.reshape(-1), nd.reshape(-1)])
        max_dy = max(int(rects[..., [0, 2]].max(initial=0)), equ[2])
        max_dx = max(int(rects[..., [1, 3]].max(initial=0)), equ[3])
        return cls(s_n0, s_cnt, s_thr, n_rects, rects, weights, thr, a_l,
                   a_r, equ, float(inv_area), max_dy, max_dx, packed)

    def device_buffer(self, device) -> torch.Tensor:
        """The packed table on ``device`` (copied once per device)."""
        key = str(torch.device(device))
        buf = self._dev.get(key)
        if buf is None:
            buf = torch.from_numpy(self.packed).to(device)
            self._dev[key] = buf
        return buf
