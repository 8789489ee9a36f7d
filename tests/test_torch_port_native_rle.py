"""The port's C RLE decoder (``maskrcnn_tf2_tpu_torch/native/``) against the
JAX package's C extension and its numpy decoder, on the CPU; and
``data/coco.py::auto_download`` against JAX's through ``file://`` zips.

Tolerance: none. Masks and run lengths are integers, so every comparison is
exact, bit for bit. The cases are those of ``tests/test_rle_native.py``,
plus what the port adds: the knob that selects numpy, a failed build that
raises instead of falling back, the library's name following its source,
and threads decoding at once.
"""

import os
import sys
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from maskrcnn_tf2_tpu.data import coco as jax_coco
from maskrcnn_tf2_tpu.native import rle as jax_native_rle

from maskrcnn_tf2_tpu_torch.data import coco
from maskrcnn_tf2_tpu_torch.kernels import _build
from maskrcnn_tf2_tpu_torch.native import rle


def _encode_counts(counts):
    """COCO's compressed counts string of run lengths (pycocotools'
    rleToString): runs past the third delta-coded against counts[i - 2],
    then base-48 6-bit varints, bit 5 the continuation bit."""
    s = []
    for i, x in enumerate(counts):
        x = int(x)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            s.append(chr((c | 0x20 if more else c) + 48))
    return "".join(s)


@pytest.fixture(scope="module")
def jax_c():
    """JAX's C extension. Asked for before any test sets the knob, which the
    JAX package reads once, at its first call."""
    native = jax_native_rle.get()
    assert native is not None, "the JAX package's C RLE extension did not build"
    return native


def _jax_c_mask(jax_c, counts, h, w):
    return np.frombuffer(jax_c.decode_mask(counts, h, w), np.uint8).reshape(w, h).T.astype(bool)


def _plain(rle_dict, h, w, monkeypatch):
    with monkeypatch.context() as m:
        m.setenv("MASKRCNN_TPU_NO_NATIVE_RLE", "1")
        return coco.rle_to_mask(rle_dict, h, w)


@pytest.mark.parametrize("seed,h,w,p", [
    (0, 37, 53, 0.5), (1, 64, 64, 0.05), (2, 128, 96, 0.95), (3, 1, 1, 0.5), (4, 200, 3, 0.3),
])
def test_seeded_masks_match_jax(seed, h, w, p, jax_c, monkeypatch):
    mask = np.random.RandomState(seed).rand(h, w) < p
    runs = coco.mask_to_rle(mask)
    for rle_dict in (runs, {"counts": _encode_counts(runs["counts"]), "size": [h, w]}):
        got = coco.rle_to_mask(rle_dict, h, w)
        assert got.dtype == bool and got.shape == (h, w)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, jax_coco.rle_to_mask(rle_dict, h, w))
        np.testing.assert_array_equal(got, _jax_c_mask(jax_c, rle_dict["counts"], h, w))
        np.testing.assert_array_equal(got, _plain(rle_dict, h, w, monkeypatch))


@pytest.mark.parametrize("fill", [False, True])
def test_degenerate_masks(fill, jax_c):
    mask = np.full((5, 7), fill)
    runs = coco.mask_to_rle(mask)
    np.testing.assert_array_equal(coco.rle_to_mask(runs, 5, 7), mask)
    np.testing.assert_array_equal(rle.decode_mask(_encode_counts(runs["counts"]), 5, 7), mask)
    np.testing.assert_array_equal(rle.decode_mask(runs["counts"], 5, 7), _jax_c_mask(jax_c, runs["counts"], 5, 7))


@pytest.mark.parametrize("counts", [
    [0, 1],
    [3, 4, 2, 9, 1, 100000],  # a multi-group varint and deltas
    [0, 70000, 12, 5, 5, 5],  # a long first run
    [2, 2, 2, 1, 3, 1],  # negative deltas (the sign bit of the last group)
    [5, 0, 0, 7],  # zero runs mid-stream
    list(np.random.RandomState(9).randint(0, 40, size=100000)),  # 100,000 runs
], ids=["short", "varint", "long-first", "negative-deltas", "zero-runs", "100000-runs"])
def test_varint_counts_match_jax(counts, jax_c, monkeypatch):
    counts = [int(c) for c in counts]
    s = _encode_counts(counts)
    assert rle.decode_counts(s) == counts
    assert rle.decode_counts(s) == list(jax_c.decode_counts(s)) == jax_coco._decode_rle_counts(s)
    assert coco._decode_rle_counts(s) == counts
    h, w = 1, sum(counts)
    np.testing.assert_array_equal(rle.decode_mask(s, h, w), _jax_c_mask(jax_c, s, h, w))
    np.testing.assert_array_equal(rle.decode_mask(s, h, w), _plain({"counts": s}, h, w, monkeypatch))


def test_short_counts_are_padded_with_zeros(jax_c, monkeypatch):
    rle_dict = {"counts": [2, 3], "size": [4, 4]}
    got = coco.rle_to_mask(rle_dict, 4, 4)
    flat = got.reshape(-1, order="F")
    assert not flat[:2].any() and flat[2:5].all() and not flat[5:].any()
    np.testing.assert_array_equal(got, _jax_c_mask(jax_c, [2, 3], 4, 4))
    np.testing.assert_array_equal(got, _plain(rle_dict, 4, 4, monkeypatch))


def test_counts_past_the_mask_are_cut(jax_c, monkeypatch):
    for counts in ([3, 30], [1, 2, 3, 4, 5, 6, 7, 8, 9]):
        got = coco.rle_to_mask({"counts": counts}, 4, 5)
        np.testing.assert_array_equal(got, _jax_c_mask(jax_c, counts, 4, 5))
        np.testing.assert_array_equal(got, _plain({"counts": counts}, 4, 5, monkeypatch))
        s = _encode_counts(counts)
        np.testing.assert_array_equal(rle.decode_mask(s, 4, 5), _jax_c_mask(jax_c, s, 4, 5))


def test_negative_run_matches_jax_c(jax_c):
    """A negative run counts as 0 in both C decoders (numpy's slices would
    not: neither decoder runs numpy on such counts)."""
    for counts in ([3, -2, 4, 5], [0, 4, -7, 6, 2], [-1, 3]):
        np.testing.assert_array_equal(rle.decode_mask(counts, 3, 5), _jax_c_mask(jax_c, counts, 3, 5))
    s = _encode_counts([4, 9, 2, 1, 3])[:-1] + chr(48 + 0x18)  # the last delta becomes -8: a run of -6
    assert rle.decode_counts(s) == list(jax_c.decode_counts(s))
    assert rle.decode_counts(s)[-1] < 0
    np.testing.assert_array_equal(rle.decode_mask(s, 4, 6), _jax_c_mask(jax_c, s, 4, 6))


@pytest.mark.parametrize("s", ["0`", "P", "1a0`"])
def test_truncated_string_raises(s, jax_c):
    for decode in (rle.decode_counts, jax_c.decode_counts):
        with pytest.raises(ValueError, match="truncated RLE counts string"):
            decode(s)
    with pytest.raises(ValueError, match="truncated RLE counts string"):
        coco.rle_to_mask({"counts": s}, 3, 3)


def test_knob_selects_numpy(jax_c, monkeypatch):
    mask = np.random.RandomState(11).rand(23, 19) < 0.4
    rle_dict = {"counts": _encode_counts(coco.mask_to_rle(mask)["counts"]), "size": [23, 19]}
    calls = []
    c_decode = rle.decode_mask
    monkeypatch.setattr(rle, "decode_mask", lambda *a: calls.append(a) or c_decode(*a))
    np.testing.assert_array_equal(coco.rle_to_mask(rle_dict, 23, 19), mask)
    assert len(calls) == 1
    monkeypatch.setenv("MASKRCNN_TPU_NO_NATIVE_RLE", "1")
    np.testing.assert_array_equal(coco.rle_to_mask(rle_dict, 23, 19), mask)
    assert len(calls) == 1  # numpy decoded it


@pytest.fixture
def fresh_build_dir(tmp_path, monkeypatch):
    """An empty build directory and no library loaded: the next call builds."""
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_libs", {})
    return build_dir


def test_failed_build_raises(fresh_build_dir, monkeypatch):
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="false failed for rle_ext.c"):
        rle.decode_counts("0")
    with pytest.raises(RuntimeError, match="false failed"):  # no silent numpy decode
        coco.rle_to_mask({"counts": [1, 2]}, 1, 3)
    assert not fresh_build_dir.exists() or not list(fresh_build_dir.glob("*.so"))
    monkeypatch.setenv("CC", os.path.join(str(fresh_build_dir), "no-such-compiler"))
    with pytest.raises(RuntimeError, match="could not run"):
        rle.decode_counts("0")
    monkeypatch.delenv("CC")
    assert rle.decode_counts("0") == [0]  # the failures cached nothing
    assert [p.name for p in fresh_build_dir.glob("*.so")] == [_build.host_target(rle.SOURCE).name]


def test_edited_source_gets_a_new_library(fresh_build_dir, tmp_path):
    edited = tmp_path / "src" / "rle_ext.c"
    edited.parent.mkdir()
    edited.write_text(rle.SOURCE.read_text() + "\n/* edited */\n")
    original, changed = _build.host_target(rle.SOURCE), _build.host_target(edited)
    assert original.name.startswith("librle_ext-") and changed.name.startswith("librle_ext-")
    assert original != changed
    lib = _build.load_host(edited, rle._SIGNATURES)
    assert changed.exists() and not original.exists()
    out = np.empty(2, np.int64)
    assert lib.decode_counts(b"01", 2, out.ctypes.data) == 2 and out.tolist() == [0, 1]


def test_threads_decode_like_serial():
    rs = np.random.RandomState(3)
    shapes = [(int(rs.randint(1, 90)), int(rs.randint(1, 90))) for _ in range(64)]
    cases = []
    for h, w in shapes:
        runs = coco.mask_to_rle(rs.rand(h, w) < rs.rand())["counts"]
        cases.append((_encode_counts(runs) if len(cases) % 2 else runs, h, w))
    serial = [rle.decode_mask(*c) for c in cases]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            threaded = list(pool.map(lambda c: rle.decode_mask(*c), cases * 4))
    finally:
        sys.setswitchinterval(interval)
    for got, want in zip(threaded, serial * 4):
        np.testing.assert_array_equal(got, want)


def _coco_source(root):
    """A COCO directory (two images, their annotations) zipped as COCO's
    files are: ``train2017.zip`` and ``annotations_trainval2017.zip``."""
    src = root / "src"
    (src / "train2017").mkdir(parents=True)
    (src / "annotations").mkdir()
    for i in range(2):
        (src / "train2017" / f"{i:012d}.jpg").write_bytes(bytes([i]) * 64)
    for subset in ("train", "val"):
        (src / "annotations" / f"instances_{subset}2017.json").write_text(f'{{"subset": "{subset}"}}')
    zips = root / "zips"
    zips.mkdir()
    for name, top in (("train2017.zip", "train2017"), ("annotations_trainval2017.zip", "annotations")):
        with zipfile.ZipFile(zips / name, "w") as zf:
            for path in sorted((src / top).iterdir()):
                zf.write(path, f"{top}/{path.name}")
    return src, {("train", "2017"): ((zips / "train2017.zip").as_uri(),
                                     (zips / "annotations_trainval2017.zip").as_uri())}


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_auto_download_through_file_urls(tmp_path, monkeypatch):
    src, urls = _coco_source(tmp_path)
    monkeypatch.setattr(coco, "COCO_URLS", urls)
    monkeypatch.setattr(jax_coco, "COCO_URLS", urls)
    assert set(coco.COCO_URLS) <= set(jax_coco.COCO_URLS)
    for package, name in ((coco, "port"), (jax_coco, "jax")):
        package.auto_download(str(tmp_path / name), "train")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax") == _tree(src)  # zips deleted after extraction
    for zipped in (tmp_path / "zips").iterdir():
        zipped.unlink()  # a second call that fetched anything would now raise
    coco.auto_download(str(tmp_path / "port"), "train")
    assert _tree(tmp_path / "port") == _tree(src)


def test_auto_download_errors_match_jax(tmp_path, monkeypatch):
    urls = {("train", "2017"): ((tmp_path / "missing.zip").as_uri(), (tmp_path / "missing_ann.zip").as_uri())}
    monkeypatch.setattr(coco, "COCO_URLS", urls)
    monkeypatch.setattr(jax_coco, "COCO_URLS", urls)
    messages = []
    for package, name in ((coco, "port"), (jax_coco, "jax")):
        with pytest.raises(RuntimeError, match="no network egress") as err:
            package.auto_download(str(tmp_path / name), "train")
        messages.append(str(err.value))
        with pytest.raises(ValueError, match="no download source for val2017"):
            package.auto_download(str(tmp_path / name), "val")
    assert messages[0] == messages[1]
