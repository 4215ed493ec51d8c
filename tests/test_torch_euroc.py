"""The port's Euroc-MAV Jacobian reader (``utils/euroc.py``) and the file
branch of ``models/slam.py`` against the JAX package's on the same files:
the checked-in sample, a write / read round trip and a synthesized
dataset's enumeration."""

import os

import numpy as np

from mixedprecisionblockqr_tpu.models import slam as jslam
from mixedprecisionblockqr_tpu.utils import euroc as jeuroc
from mixedprecisionblockqr_tpu_torch.models import slam as tslam
from mixedprecisionblockqr_tpu_torch.utils import euroc as teuroc

SAMPLE = os.path.join(os.path.dirname(__file__), "data", "A_000000100.txt")


def test_sample_parses_as_the_reference():
    m, n, a = teuroc.read_euroc_jacobian(SAMPLE)
    mj, nj, aj = jeuroc.read_euroc_jacobian(SAMPLE)
    assert (m, n) == (mj, nj) == (12, 9) == teuroc.read_dims(SAMPLE)
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, aj)
    assert a[0, 0] == np.float32(1.519444552307129e02)
    assert np.count_nonzero(a) == 28


def test_write_read_roundtrip(tmp_path):
    a = np.random.default_rng(3).standard_normal((9, 7)).astype(np.float32)
    a[np.abs(a) < 0.8] = 0.0
    p = str(tmp_path / "A_000000200.txt")
    teuroc.write_euroc_jacobian(p, a)
    m, n, b = teuroc.read_euroc_jacobian(p)
    assert (m, n) == (9, 7)
    np.testing.assert_array_equal(b, jeuroc.read_euroc_jacobian(p)[2])
    np.testing.assert_allclose(b, a, rtol=1e-7)


def test_missing_file_raises(tmp_path):
    try:
        teuroc.read_euroc_jacobian(str(tmp_path / "none.txt"))
    except FileNotFoundError:
        return
    raise AssertionError("no FileNotFoundError")


def test_synthesized_dataset_enumerates_as_the_reference(tmp_path):
    sizes = ((40, 16), (24, 12), (64, 32), (32, 8), (48, 24))
    paths = teuroc.synthesize_dataset(str(tmp_path / "t"), sizes=sizes)
    jpaths = jeuroc.synthesize_dataset(str(tmp_path / "j"), sizes=sizes)
    assert [os.path.basename(p) for p in paths] == [
        os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        with open(p) as f, open(q) as g:
            assert f.read() == g.read()
    cases = tslam.enumerate_jacobians(str(tmp_path / "t"), max_matrices=2)
    jcases = jslam.enumerate_jacobians(str(tmp_path / "j"), max_matrices=2)
    assert [(c.name, c.m, c.n) for c in cases] == [
        (c.name, c.m, c.n) for c in jcases]
    assert [c.m for c in cases] == [24, 40]
    for c, cj in zip(cases, jcases):
        np.testing.assert_array_equal(c.load(), cj.load())
