"""The port's cascade I/O against the JAX package's.

The port keeps its own copies of the XML parser and writer, the CART text
format and the model zoo (it never imports the JAX package).  Here they
are held EQUAL to the JAX package's: the writer byte for byte, the
parsers array for array and dtype for dtype, on all 19 zoo cascades; the
new format on a document built here from the zoo; the ``.npz`` artifacts
across packages; the zoo's search through ``$CLFD_CASCADE_DIR``; and an
XML-loaded cascade through ``CascadeClassifier`` on the CPU.
"""

import re

import numpy as np
import pytest
import torch

from clfacedetection_tpu import CascadeClassifier as JClassifier
from clfacedetection_tpu.models import cart_text as jcart
from clfacedetection_tpu.models import haar_xml as jxml
from clfacedetection_tpu.models import zoo as jzoo
from clfacedetection_tpu.models.haar_xml_writer import \
    haar_xml_bytes as j_xml_bytes
from clfacedetection_tpu.models.spec import CascadeSpec as JSpec

import clfacedetection_torch as ct
from clfacedetection_torch.models import ARRAY_FIELDS, CASCADE_NAMES
from clfacedetection_torch.models import cart_text as tcart
from clfacedetection_torch.models import haar_xml as txml
from clfacedetection_torch.models import zoo as tzoo
from clfacedetection_torch.models.haar_xml_writer import \
    haar_xml_bytes as t_xml_bytes
from clfacedetection_torch.models.haar_xml_writer import write_haar_xml
from clfacedetection_torch.models.spec import CascadeSpec as TSpec
from clfacedetection_torch.utils import synth_scene

torch.set_num_threads(1)

# what the new (opencv-cascade-classifier) format cannot carry: stage-tree
# links; its parser makes every cascade sequential (parent i-1, next -1)
NEW_FORMAT_LOSES = ("stage_parent", "stage_next", "stage_child")


def same_spec(a, b, fields=ARRAY_FIELDS):
    """Equal window, and every array equal in shape, dtype and value."""
    assert (a.window_w, a.window_h) == (b.window_w, b.window_h)
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f"{f}: {x.dtype} != {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f)


def _fmt(v):
    return repr(float(np.float32(v)))


def new_format_bytes(spec) -> bytes:
    """``spec`` as an OpenCV >= 2.4 (opencv-cascade-classifier) document:
    one shared ``<features>`` table, ``internalNodes`` of (left, right,
    feature, threshold) with leaf links as ``-(leaf + 1)``."""
    feats, stages = [], []
    for s in range(spec.n_stages):
        weak = []
        c0 = int(spec.stage_clf_ofs[s])
        for c in range(c0, c0 + int(spec.stage_clf_cnt[s])):
            n0, cnt = int(spec.clf_node_ofs[c]), int(spec.clf_node_cnt[c])
            a0 = int(spec.clf_alpha_ofs[c])
            internal = []
            for node in range(n0, n0 + cnt):
                rects = []
                for r in range(3):
                    wt = spec.rect_weight[node, r]
                    if r >= 1 and wt == 0.0 and (r >= 2
                                                 or spec.rect_w[node, r] == 0):
                        continue
                    rects.append("<_>%d %d %d %d %s</_>" % (
                        spec.rect_x[node, r], spec.rect_y[node, r],
                        spec.rect_w[node, r], spec.rect_h[node, r], _fmt(wt)))
                feats.append(f"<_><rects>{''.join(rects)}</rects>"
                             f"<tilted>{int(spec.tilted[node])}</tilted></_>")
                links = [int(spec.left[node]), int(spec.right[node])]
                links = [k if k > 0 else k - 1 for k in links]
                internal.append(f"{links[0]} {links[1]} {len(feats) - 1} "
                                f"{_fmt(spec.node_threshold[node])}")
            leaves = " ".join(_fmt(a) for a in spec.alphas[a0:a0 + cnt + 1])
            weak.append(f"<_><internalNodes>{' '.join(internal)}"
                        f"</internalNodes><leafValues>{leaves}</leafValues>"
                        f"</_>")
        stages.append(f"<_><maxWeakCount>{len(weak)}</maxWeakCount>"
                      f"<stageThreshold>{_fmt(spec.stage_threshold[s])}"
                      f"</stageThreshold><weakClassifiers>{''.join(weak)}"
                      f"</weakClassifiers></_>")
    return ("<?xml version=\"1.0\"?>\n<opencv_storage>\n"
            "<cascade type_id=\"opencv-cascade-classifier\">"
            "<stageType>BOOST</stageType><featureType>HAAR</featureType>"
            f"<height>{spec.window_h}</height><width>{spec.window_w}</width>"
            f"<stages>{''.join(stages)}</stages>"
            f"<features>{''.join(feats)}</features>"
            "</cascade>\n</opencv_storage>\n").encode()


@pytest.mark.parametrize("name", CASCADE_NAMES)
def test_writer_bytes_and_parse_equal_jax(name):
    """The port's writer emits the JAX writer's bytes; the port's parse of
    them equals the JAX parse and the ``.npz`` spec, dtype for dtype."""
    t_spec = tzoo.load_cascade(name)
    j_spec = jzoo.load_cascade(name)
    data = j_xml_bytes(j_spec)
    assert t_xml_bytes(t_spec) == data
    t_parsed = txml.parse_haar_xml_bytes(data, name)
    j_parsed = jxml.parse_haar_xml_bytes(data, name)
    same_spec(t_parsed, j_parsed)
    same_spec(t_parsed, t_spec)
    assert t_parsed.name == j_parsed.name == name


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt",
                                  "haarcascade_frontalface_alt2",
                                  "haarcascade_frontalface_alt_tree"])
def test_new_format_parse_equals_jax(name):
    """stumps (alt), CART trees (alt2), a stage tree (alt_tree): both
    parsers give equal specs; everything but the stage-tree links equals
    the zoo's, and those equal the zoo's wherever it is sequential."""
    spec = tzoo.load_cascade(name)
    data = new_format_bytes(spec)
    t_parsed = txml.parse_haar_xml_bytes(data, name)
    same_spec(t_parsed, jxml.parse_haar_xml_bytes(data, name))
    kept = [f for f in ARRAY_FIELDS if f not in NEW_FORMAT_LOSES]
    same_spec(t_parsed, spec, kept)
    assert not t_parsed.is_tree
    if spec.is_tree:
        assert any(not np.array_equal(getattr(t_parsed, f), getattr(spec, f))
                   for f in NEW_FORMAT_LOSES)
    else:
        same_spec(t_parsed, spec, NEW_FORMAT_LOSES)


@pytest.mark.parametrize("data", [
    b"<a><!----------- dashes -- inside ----------><b/></a>",
    b"x<!-- one -->y<!-- two -->z",
    b"<a>kept</a><!-- unterminated",
    b"no comment at all",
])
def test_strip_comments_equals_jax(data):
    assert txml._strip_comments(data) == jxml._strip_comments(data)


def test_mcs_style_comment_header_parses():
    spec = tzoo.load_cascade("haarcascade_eye")
    data = t_xml_bytes(spec).replace(
        b"<opencv_storage>",
        b"<opencv_storage>\n<!--------------------------------------\n"
        b"  a header -- with dashes\n--------------------------------->", 1)
    same_spec(txml.parse_haar_xml_bytes(data), spec)


_GOOD = t_xml_bytes(tzoo.load_cascade("haarcascade_eye"))


@pytest.mark.parametrize("bad", [
    b"<not_storage/>",
    b"<opencv_storage><x type_id=\"other\"/></opencv_storage>",
    _GOOD.replace(b"<size>20 20</size>", b"<size></size>", 1),
    _GOOD.replace(b"<stages>", b"<nostages>", 1).replace(
        b"</stages>", b"</nostages>", 1),
    b"<opencv_storage><c type_id=\"opencv-cascade-classifier\">"
    b"<featureType>LBP</featureType></c></opencv_storage>",
    b"<opencv_storage><unclosed></opencv_storage>",
], ids=["root", "no_cascade", "empty_size", "no_stages", "lbp", "syntax"])
def test_malformed_raises_like_jax(bad):
    with pytest.raises(Exception) as j_err:
        jxml.parse_haar_xml_bytes(bad)
    with pytest.raises(Exception) as t_err:
        txml.parse_haar_xml_bytes(bad)
    assert type(t_err.value) is type(j_err.value)
    assert str(t_err.value) == str(j_err.value)


def test_rect_line_of_four_entries_raises_like_jax():
    m = re.search(rb"<_>(-?\d+ -?\d+ -?\d+ -?\d+) \S+</_>", _GOOD)
    bad = _GOOD[:m.start()] + b"<_>" + m.group(1) + b"</_>" + _GOOD[m.end():]
    with pytest.raises(ValueError) as j_err:
        jxml.parse_haar_xml_bytes(bad)
    with pytest.raises(ValueError) as t_err:
        txml.parse_haar_xml_bytes(bad)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt2",
                                  "haarcascade_frontalface_alt_tree",
                                  "haarcascade_mcs_nose"])
def test_cart_text_round_trip_equals_jax(name, tmp_path):
    spec = tzoo.load_cascade(name)
    stages = tcart.cart_text_stages(spec)
    assert stages == jcart.cart_text_stages(jzoo.load_cascade(name))
    win = (spec.window_w, spec.window_h)
    t_parsed = tcart.parse_cart_text(stages, win, name)
    same_spec(t_parsed, jcart.parse_cart_text(stages, win, name))
    same_spec(t_parsed, spec)
    root = tmp_path / name
    for i, text in enumerate(stages[:6]):
        (root / str(i)).mkdir(parents=True)
        (root / str(i) / "AdaBoostCARTHaarClassifier.txt").write_text(text)
    t_dir = tcart.load_cascade_directory(str(root), win)
    same_spec(t_dir, jcart.load_cascade_directory(str(root), win))
    assert t_dir.name == name and t_dir.n_stages == 6
    with pytest.raises(FileNotFoundError):
        tcart.load_cascade_directory(str(tmp_path / "empty"), win)


@pytest.mark.parametrize("name", ["haarcascade_eye",
                                  "haarcascade_frontalface_alt_tree"])
def test_save_by_one_package_loads_in_the_other(name, tmp_path):
    t_spec = tzoo.load_cascade(name)
    j_spec = jzoo.load_cascade(name)
    t_spec.save(str(tmp_path / "t.npz"))
    j_spec.save(str(tmp_path / "j.npz"))
    j_from_t = JSpec.load(str(tmp_path / "t.npz"))
    t_from_j = TSpec.load(str(tmp_path / "j.npz"))
    same_spec(j_from_t, t_spec)
    same_spec(t_from_j, t_spec)
    assert j_from_t.name == t_from_j.name == name
    same_spec(TSpec.from_bytes(j_spec.to_bytes()), t_spec)
    same_spec(JSpec.from_bytes(t_spec.to_bytes()), t_spec)
    c = t_spec.clone()
    same_spec(c, t_spec)
    c.alphas[0] += 1
    assert c.alphas[0] != t_spec.alphas[0]


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt",
                                  "haarcascade_mcs_nose",
                                  "haarcascade_frontalface_alt_tree"])
def test_spec_properties_equal_jax(name):
    t, j = tzoo.load_cascade(name), jzoo.load_cascade(name)
    for p in ("n_tilted_nodes", "max_stage_classifiers", "is_tree",
              "has_tilted", "is_stump_based"):
        assert getattr(t, p) == getattr(j, p), p
    for s in (0, t.n_stages // 2, t.n_stages - 1):
        np.testing.assert_array_equal(t.stage_nodes(s), j.stage_nodes(s))
    t.validate()


@pytest.mark.parametrize("break_it", ["rect", "link", "leaf"])
def test_validate_raises_like_jax(break_it):
    t = tzoo.load_cascade("haarcascade_frontalface_alt2").clone()
    j = jzoo.load_cascade("haarcascade_frontalface_alt2").clone()
    for s in (t, j):
        if break_it == "rect":
            s.rect_x[5, 0] = s.window_w
        elif break_it == "link":
            s.left[int(s.clf_node_ofs[3])] = 7
        else:
            s.right[int(s.clf_node_ofs[3])] = -9
    with pytest.raises(ValueError) as j_err:
        j.validate()
    with pytest.raises(ValueError) as t_err:
        t.validate()
    assert str(t_err.value) == str(j_err.value)


def test_load_cascade_by_xml_path_and_by_name(tmp_path, monkeypatch):
    spec = tzoo.load_cascade("haarcascade_frontalface_alt")
    path = str(tmp_path / "xml_route_alt.xml")
    write_haar_xml(spec, path)
    loaded = ct.load_cascade(path)
    same_spec(loaded, spec)
    assert loaded.name == "xml_route_alt"
    monkeypatch.setenv("CLFD_CASCADE_DIR", str(tmp_path))
    by_name = tzoo.load_cascade("xml_route_alt")
    same_spec(by_name, spec)
    found = tzoo.available_cascades()
    assert found == jzoo.available_cascades()
    assert found["xml_route_alt"] == path
    # the artifacts come first, then the XML directory
    assert found["haarcascade_frontalface_alt"].endswith(".npz")
    with pytest.raises(FileNotFoundError):
        tzoo.load_cascade("no_such_cascade_here")


def test_classifier_from_xml_equals_npz_and_jax(tmp_path):
    """An XML-loaded cascade through ``CascadeClassifier`` on the CPU gives
    the ``.npz`` route's boxes and the JAX ``CascadeClassifier``'s."""
    spec = tzoo.load_cascade("haarcascade_frontalface_alt")
    path = str(tmp_path / "haarcascade_frontalface_alt.xml")
    write_haar_xml(spec, path)
    gray = synth_scene((120, 160), faces=((60, 80, 70.0),), seed=9)
    kw = dict(min_neighbors=2, min_size=(20, 20))
    from_xml = ct.CascadeClassifier(path, device="cpu").detect_multi_scale2(
        gray, **kw)
    from_npz = ct.CascadeClassifier("haarcascade_frontalface_alt",
                                    device="cpu").detect_multi_scale2(
        gray, **kw)
    jax_b, jax_n = JClassifier("haarcascade_frontalface_alt") \
        .detect_multi_scale2(gray, **kw)
    assert len(jax_b) > 0
    for got in (from_xml, from_npz):
        np.testing.assert_array_equal(got[0], jax_b)
        np.testing.assert_array_equal(got[1], jax_n)
    objs = ct.detect_objects(gray, path, min_window_size=(20, 20),
                             min_neighbors=2, device="cpu")
    assert len(objs) > 0


def test_import_models_tool(tmp_path, monkeypatch):
    from clfacedetection_torch.tools import import_models
    src, dst = tmp_path / "xml", tmp_path / "npz"
    src.mkdir()
    for name in ("haarcascade_eye", "haarcascade_mcs_nose"):
        write_haar_xml(tzoo.load_cascade(name), str(src / f"{name}.xml"))
    monkeypatch.delenv("CLFD_CASCADE_DIR", raising=False)
    with pytest.raises(SystemExit):
        import_models.main(["--dst", str(dst)])      # no --src, no env
    monkeypatch.setenv("CLFD_CASCADE_DIR", str(src))
    assert import_models.main(["--dst", str(dst)]) == 0
    for name in ("haarcascade_eye", "haarcascade_mcs_nose"):
        same_spec(JSpec.load(str(dst / f"{name}.npz")),
                  tzoo.load_cascade(name))
