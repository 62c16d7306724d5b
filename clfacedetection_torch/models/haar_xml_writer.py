"""Old-format OpenCV Haar-cascade XML writer.

A copy of ``clfacedetection_tpu/models/haar_xml_writer.py`` (numpy only),
kept in this package so that it never imports the JAX package. Its bytes
equal the JAX package's writer's for the same spec.

Counterpart of the reference's ``icvWriteHaarClassifier``
(tempcv.cpp:2092-2196): serializes a :class:`CascadeSpec` back to the
``type_id="opencv-haar-classifier"`` dialect so models edited or trained in
this framework round-trip with OpenCV-era tooling.  Output parses back
bit-identically through :func:`models.haar_xml.parse_haar_xml_bytes`
(round-trip tested on the whole bundled zoo).
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np

from .spec import CascadeSpec

__all__ = ["write_haar_xml", "haar_xml_bytes"]


def _fmt_float(v: float) -> str:
    """Round-trippable float text (matches float32 exactly on re-parse)."""
    return repr(float(np.float32(v)))


def haar_xml_bytes(spec: CascadeSpec) -> bytes:
    out = io.StringIO()
    w = out.write
    tag = spec.name.replace(" ", "_") or "cascade"
    w('<?xml version="1.0"?>\n<opencv_storage>\n')
    w(f'<{tag} type_id="opencv-haar-classifier">\n')
    w(f"  <size>{spec.window_w} {spec.window_h}</size>\n")
    w("  <stages>\n")
    for s in range(spec.n_stages):
        w("    <_>\n      <trees>\n")
        c0 = int(spec.stage_clf_ofs[s])
        for c in range(c0, c0 + int(spec.stage_clf_cnt[s])):
            w("        <_>\n")
            n0 = int(spec.clf_node_ofs[c])
            cnt = int(spec.clf_node_cnt[c])
            a0 = int(spec.clf_alpha_ofs[c])
            for k in range(cnt):
                node = n0 + k
                w("          <_>\n            <feature>\n"
                  "              <rects>\n")
                for r in range(3):
                    if spec.rect_weight[node, r] == 0.0 and r >= 2:
                        continue
                    if r >= 1 and spec.rect_weight[node, r] == 0.0 \
                            and spec.rect_w[node, r] == 0:
                        continue
                    w("                <_>%d %d %d %d %s</_>\n" % (
                        spec.rect_x[node, r], spec.rect_y[node, r],
                        spec.rect_w[node, r], spec.rect_h[node, r],
                        _fmt_float(spec.rect_weight[node, r])))
                w("              </rects>\n")
                w(f"              <tilted>{int(spec.tilted[node])}</tilted>\n")
                w("            </feature>\n")
                w(f"            <threshold>"
                  f"{_fmt_float(spec.node_threshold[node])}</threshold>\n")
                left = int(spec.left[node])
                right = int(spec.right[node])
                if left > 0:
                    w(f"            <left_node>{left}</left_node>\n")
                else:
                    w(f"            <left_val>"
                      f"{_fmt_float(spec.alphas[a0 - left])}</left_val>\n")
                if right > 0:
                    w(f"            <right_node>{right}</right_node>\n")
                else:
                    w(f"            <right_val>"
                      f"{_fmt_float(spec.alphas[a0 - right])}</right_val>\n")
                w("          </_>\n")
            w("        </_>\n")
        w("      </trees>\n")
        w(f"      <stage_threshold>"
          f"{_fmt_float(spec.stage_threshold[s])}</stage_threshold>\n")
        w(f"      <parent>{int(spec.stage_parent[s])}</parent>\n")
        w(f"      <next>{int(spec.stage_next[s])}</next>\n")
        w("    </_>\n")
    w("  </stages>\n")
    w(f"</{tag}>\n</opencv_storage>\n")
    return out.getvalue().encode()


def write_haar_xml(spec: CascadeSpec, path_or_file: Union[str, io.IOBase]):
    data = haar_xml_bytes(spec)
    if isinstance(path_or_file, str):
        with open(path_or_file, "wb") as f:
            f.write(data)
    else:
        path_or_file.write(data)
