"""The cascade at scale 1, packed once for every kernel.

Every cascade of the zoo is, per classifier, a CART tree of at most three
nodes (a stump is the tree of one node).  A node is up to three weighted
rects read from one plane (the upright ``sum`` integral or the tilted
RSAT), a threshold and two links: a link ``> 0`` is the next node of the
classifier, a link ``<= 0`` the leaf ``alpha[-link]``.  ``CascadeTable``
holds those as numpy arrays (read by the plain PyTorch versions) and as
ONE int32 buffer (read by the CUDA kernels), so both read the same
numbers.  The buffer layout is defined here and in ``csrc/cascade.cuh``:

* stages, ``STAGE_WORDS`` each: first classifier, classifier count,
  threshold (f32 bits), and the classifier stride ``clf_words``;
* then classifiers, ``clf_words = CLF_HEAD + T * NODE_WORDS`` each: a
  head of ``CLF_HEAD`` words (node count, ``alpha[0..T]`` as f32 bits,
  zeros), then ``T`` nodes of ``NODE_WORDS``: rect count, plane (0 sum,
  1 tilted), left, right, threshold, 3 weights (f32 bits), then 3 rects
  of four (y, x) corners with signs + - - +.

Every stage, classifier, node and rect starts on a 16-byte boundary, so
the kernels read the table in 16-byte vectors; a stump takes 160 bytes.

tail2 walks stump cascades with upright rects only, and reads them from a
compact view of the same numbers, ``stumps`` (built here, read by
``clfd_stump_stage_sum`` in ``csrc/cascade.cuh``): the stage records with
word 3 set to 0, then ``STUMP_WORDS`` per classifier: rect count, three
rects as (ya, xa, yb, xb), three weights, threshold, left and right leaf
values (f32 bits), 0.  A stump takes 80 bytes there: tail2 runs one
thread per survivor and reads every table word of every stage it walks,
so it keeps the compact form.

The v1 tail reads a third view, ``nodes``: ``NODE_VIEW_WORDS`` per node
``(c, t)`` in column order ``c * T + t``: rect count, then the three
rects' four corners as offsets into the node's window patch (``plane *
ph * pw + y * pw + x`` for a patch of ``ph = max_dy + 1`` rows and ``pw =
max_dx + 1`` columns, the tilted plane's after the ``sum`` plane's), then
the three weights (f32 bits), and zero records up to a multiple of
``NODE_VIEW_PAD`` nodes.  64 bytes a node: the kernel reads each record
once for 32 survivors, and the records of ``NODE_VIEW_PAD`` nodes at a
time.

The decisions kernel (``csrc/tail_rows.cu``) reads a fourth view,
``rows``: the stage records, then ``ROW_WORDS`` per classifier: the
thresholds of its three nodes (f32 bits), their left links, their right
links, ``alpha[0..3]`` (f32 bits) and three zeros; absent nodes and
leaves are zeros.  64 bytes a classifier: a lane reads one record and
walks it for every live slot of its warp.

Rects of weight 0 are left out, as the JAX package's front skips them;
the rest keep their order.  Absent rects and nodes are zeros.  Source:
``_build_clf_tables(c, [1.0])`` (the JAX package's
``detect/detector.py``).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.compile import CompiledCascade

if TYPE_CHECKING:
    from ..detect.detector import _ClfTables

__all__ = ["CascadeTable", "STAGE_WORDS", "CLF_HEAD", "NODE_WORDS",
           "MAX_T", "STUMP_WORDS", "NODE_VIEW_WORDS", "NODE_VIEW_PAD",
           "ROW_WORDS"]

STAGE_WORDS = 4
CLF_HEAD = 8
NODE_WORDS = 32
MAX_T = 3
STUMP_WORDS = 20
NODE_VIEW_WORDS = 16
NODE_VIEW_PAD = 128
ROW_WORDS = 16


@dataclasses.dataclass
class CascadeTable:
    stage_clf0: np.ndarray    # int32 [S] first classifier
    stage_cnt: np.ndarray     # int32 [S]
    stage_thr: np.ndarray     # float32 [S] (bias applied)
    clf_nodes: np.ndarray     # int32 [C] valid nodes per classifier
    alpha: np.ndarray         # float32 [C, T+1]
    n_rects: np.ndarray       # int32 [C, T]
    tilted: np.ndarray        # bool [C, T]
    left: np.ndarray          # int32 [C, T]
    right: np.ndarray         # int32 [C, T]
    thr: np.ndarray           # float32 [C, T]
    weights: np.ndarray       # float32 [C, T, 3]
    corners: np.ndarray       # int32 [C, T, 3, 4, 2] (y, x) per corner
    equ: tuple                # (ya, xa, yb, xb) of the variance rect
    inv_area: float           # 1 / area of the variance rect
    max_dy: int               # largest corner row offset
    max_dx: int               # largest corner column offset
    packed: np.ndarray        # int32 [S*STAGE_WORDS + C*clf_words]
    stumps: Optional[np.ndarray]  # int32 [S*STAGE_WORDS + C*STUMP_WORDS],
    #                               None unless stumps with upright rects
    nodes: np.ndarray         # int32 [C*T (padded)*NODE_VIEW_WORDS]
    rows: np.ndarray          # int32 [S*STAGE_WORDS + C*ROW_WORDS]
    # table words the front kernel stages, by front_k (ops/haar_front.py
    # front_launch)
    front_words: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    # what ``cached`` made on a device, by device and key
    cache: Dict[tuple, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return int(self.stage_cnt.shape[0])

    @property
    def n_clf(self) -> int:
        return int(self.clf_nodes.shape[0])

    @property
    def T(self) -> int:
        return int(self.n_rects.shape[1])

    @property
    def clf_words(self) -> int:
        return CLF_HEAD + self.T * NODE_WORDS

    @property
    def has_tilted(self) -> bool:
        return bool(self.tilted.any())

    @classmethod
    def build(cls, c: CompiledCascade, tables: _ClfTables,
              equ_y, equ_x, inv_area: float) -> "CascadeTable":
        """Pack the scale-1 tables (``_build_clf_tables(c, [1.0])``) of
        the classifiers that the stages of ``c`` use (fewer than the
        tables hold when ``c`` was truncated)."""
        spec = c.spec
        T = tables.T
        n = int((spec.stage_clf_ofs + spec.stage_clf_cnt).max(initial=0))
        if T > MAX_T:
            raise NotImplementedError(
                f"classifiers of {T} nodes: the table holds at most {MAX_T}")
        cy, cx, w = (tables.corner_y[0, :n], tables.corner_x[0, :n],
                     tables.weight[0, :n])          # [C, T, 3, 4], [C, T, 3]
        nodes = tables.clf_valid_nodes[:n].astype(np.int32)
        corners = np.zeros((n, T, 3, 4, 2), np.int32)
        weights = np.zeros((n, T, 3), np.float32)
        n_rects = np.zeros((n, T), np.int32)
        for i in range(n):
            for t in range(int(nodes[i])):
                for link in (tables.left[i, t], tables.right[i, t]):
                    # links point forward, so a walk ends within T steps
                    if link > 0 and not t < link < nodes[i]:
                        raise ValueError(f"classifier {i} node {t}: link "
                                         f"{link} is not a later node")
                for k in range(3):
                    if w[i, t, k] == 0.0:
                        continue
                    j = n_rects[i, t]
                    corners[i, t, j, :, 0] = cy[i, t, k]
                    corners[i, t, j, :, 1] = cx[i, t, k]
                    weights[i, t, j] = w[i, t, k]
                    n_rects[i, t] += 1
        valid = np.arange(T)[None] < nodes[:, None]
        tilted = tables.use_tilted[:n] & valid
        left = np.where(valid, tables.left[:n], 0).astype(np.int32)
        right = np.where(valid, tables.right[:n], 0).astype(np.int32)
        thr = np.where(valid, tables.threshold[:n], 0).astype(np.float32)
        alpha = tables.alpha[:n].astype(np.float32)
        s_c0 = spec.stage_clf_ofs.astype(np.int32)
        s_cnt = spec.stage_clf_cnt.astype(np.int32)
        s_thr = np.asarray(c.stage_threshold, np.float32)
        equ = (int(equ_y[0]), int(equ_x[0]), int(equ_y[2]), int(equ_x[1]))

        S = len(s_cnt)
        st = np.zeros((S, STAGE_WORDS), np.int32)
        st[:, 0], st[:, 1] = s_c0, s_cnt
        st[:, 2] = s_thr.view(np.int32)
        st[:, 3] = CLF_HEAD + T * NODE_WORDS
        cl = np.zeros((n, CLF_HEAD + T * NODE_WORDS), np.int32)
        cl[:, 0] = nodes
        cl[:, 1:2 + T] = alpha.view(np.int32)
        nd = np.zeros((n, T, NODE_WORDS), np.int32)
        nd[..., 0] = n_rects
        nd[..., 1] = tilted
        nd[..., 2] = left
        nd[..., 3] = right
        nd[..., 4] = thr.view(np.int32)
        nd[..., 5:8] = weights.view(np.int32)
        nd[..., 8:32] = corners.reshape(n, T, 24)
        cl[:, CLF_HEAD:] = nd.reshape(n, T * NODE_WORDS)
        packed = np.concatenate([st.reshape(-1), cl.reshape(-1)])
        stumps = _pack_stumps(st, n_rects, corners, weights, thr, alpha,
                              left, right, tilted)
        max_dy = max(int(corners[..., 0].max(initial=0)), equ[2])
        max_dx = max(int(corners[..., 1].max(initial=0)), equ[3])
        if corners.min(initial=0) < 0:
            raise ValueError("a rect corner lies left of or above its window")
        node_view = _pack_nodes(n_rects, tilted, corners, weights, max_dy,
                                max_dx)
        rv = np.zeros((n, ROW_WORDS), np.int32)
        rv[:, 0:T] = thr.view(np.int32)
        rv[:, 3:3 + T] = left
        rv[:, 6:6 + T] = right
        rv[:, 9:10 + T] = alpha.view(np.int32)
        rows = np.concatenate([st.reshape(-1), rv.reshape(-1)])
        return cls(s_c0, s_cnt, s_thr, nodes, alpha, n_rects, tilted, left,
                   right, thr, weights, corners, equ, float(inv_area),
                   max_dy, max_dx, packed, stumps, node_view, rows)

    def device_buffer(self, device, stumps: bool = False,
                      nodes: bool = False, rows: bool = False
                      ) -> torch.Tensor:
        """The packed table, or with ``stumps`` its stump view, with
        ``nodes`` its node view, with ``rows`` its rows view, on ``device``
        (copied once per device)."""
        if stumps and self.stumps is None:
            raise ValueError("the cascade has no stump view: it holds CART "
                             "classifiers or tilted or non-upright rects")
        view = ("stumps" if stumps else "nodes" if nodes
                else "rows" if rows else "packed")
        return self.cached((view,), device, lambda: torch.from_numpy(
            getattr(self, view)).to(device))

    def cached(self, key: tuple, device, make: Callable[[], Any]) -> Any:
        """What ``make()`` builds from the table's arrays on ``device`` (a
        tensor or a tuple of them), kept under ``key`` and the device for
        the table's life.  The kernels' buffers and the plain versions'
        tables come from it, so that a run copies nothing from the host
        once they are made, and a CUDA graph can hold it.  ``key`` names
        what is made: the view, the slice and the dtype.  The first call for a key and a
        CUDA device must come before any graph captures it (a warm-up
        run), as the copy from pageable host memory cannot be captured."""
        device = torch.device(device)
        k = (str(device),) + tuple(key)
        v = self.cache.get(k)
        if v is None:
            if device.type == "cuda" \
                    and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"the table's {key} is first needed on {device} inside "
                    f"a CUDA graph capture: run the path once before "
                    f"capturing it")
            v = make()
            self.cache[k] = v
        return v


def _pack_stumps(st, n_rects, corners, weights, thr, alpha, left, right,
                 tilted) -> Optional[np.ndarray]:
    """The stump view (module docstring) of the packed stage records and
    the table's arrays, or None when a classifier has more than one node
    or a rect is tilted or not upright."""
    n, T = n_rects.shape
    if T != 1 or tilted.any() or (left > 0).any() or (right > 0).any():
        return None
    y, x = corners[:, 0, :, :, 0], corners[:, 0, :, :, 1]   # [C, 3, 4]
    if not ((y[..., 0] == y[..., 1]) & (y[..., 2] == y[..., 3])
            & (x[..., 0] == x[..., 2]) & (x[..., 1] == x[..., 3])).all():
        return None
    sv = st.copy()
    sv[:, 3] = 0
    idx = np.arange(n)
    nd = np.zeros((n, STUMP_WORDS), np.int32)
    nd[:, 0] = n_rects[:, 0]
    nd[:, 1:13] = np.stack([y[..., 0], x[..., 0], y[..., 2], x[..., 1]],
                           axis=-1).reshape(n, 12)
    nd[:, 13:16] = weights[:, 0].view(np.int32)
    nd[:, 16] = thr[:, 0].view(np.int32)
    nd[:, 17] = alpha[idx, -left[:, 0]].view(np.int32)
    nd[:, 18] = alpha[idx, -right[:, 0]].view(np.int32)
    return np.concatenate([sv.reshape(-1), nd.reshape(-1)])


def _pack_nodes(n_rects, tilted, corners, weights, max_dy,
                max_dx) -> np.ndarray:
    """The node view (module docstring): per node its rect count, the
    twelve corner offsets into the window patch and the three weights."""
    n, T = n_rects.shape
    ph, pw = max_dy + 1, max_dx + 1
    off = (tilted[:, :, None, None] * (ph * pw) + corners[..., 0] * pw
           + corners[..., 1])                              # [C, T, 3, 4]
    live = np.arange(3)[None, None] < n_rects[..., None]
    nd = np.zeros((n, T, NODE_VIEW_WORDS), np.int32)
    nd[..., 0] = n_rects
    nd[..., 1:13] = np.where(live[..., None], off, 0).reshape(n, T, 12)
    nd[..., 13:16] = weights.view(np.int32)
    pad = -(n * T) % NODE_VIEW_PAD
    return np.concatenate([nd.reshape(-1),
                           np.zeros(pad * NODE_VIEW_WORDS, np.int32)])
