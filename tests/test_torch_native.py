"""The port's native Euroc parser (``mixedprecisionblockqr_tpu_torch/native``,
built with ``g++`` into the port's ``_build/native/``) against the JAX
package's numpy reader: the checked-in sample, a native write / read round
trip, messy whitespace, and ``utils/euroc.py`` taking the native path.
Skips without a C++ toolchain, as ``tests/test_native.py`` does."""

import os

import numpy as np
import pytest

import mixedprecisionblockqr_tpu.utils.euroc as jeuroc
from mixedprecisionblockqr_tpu_torch.native.build import SO, build
from mixedprecisionblockqr_tpu_torch.utils import euroc as teuroc

SAMPLE = os.path.join(os.path.dirname(__file__), "data", "A_000000100.txt")


@pytest.fixture(scope="module")
def native():
    if build() is None:
        pytest.skip("no C++ toolchain available")
    from mixedprecisionblockqr_tpu_torch.native import euroc_native

    return euroc_native


def _numpy_reference(path):
    """The JAX package's reader with its native parser switched off."""
    old = jeuroc._native, jeuroc._native_checked
    jeuroc._native, jeuroc._native_checked = None, True
    try:
        return jeuroc.read_euroc_jacobian(path)
    finally:
        jeuroc._native, jeuroc._native_checked = old


def test_builds_into_the_ports_build_dir(native):
    assert os.path.exists(SO)
    assert os.sep.join(("mixedprecisionblockqr_tpu_torch", "_build",
                        "native")) in SO


def test_sample_matches_numpy_reference(native):
    m, n, a = native.parse_file(SAMPLE)
    m2, n2, b = _numpy_reference(SAMPLE)
    assert (m, n) == (m2, n2) == (12, 9)
    np.testing.assert_array_equal(a, b)


def test_native_roundtrip(native, tmp_path):
    rng = np.random.default_rng(0)
    a = np.where(rng.random((64, 48)) < 0.2,
                 rng.standard_normal((64, 48)), 0.0).astype(np.float32)
    p = str(tmp_path / "A_000000100.txt")
    assert native.write_file(p, a) == int(np.count_nonzero(a))
    m, n, b = native.parse_file(p)
    assert (m, n) == (64, 48)
    np.testing.assert_array_equal(b, _numpy_reference(p)[2])
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_messy_whitespace(native, tmp_path):
    p = str(tmp_path / "A_messy.txt")
    with open(p, "w") as f:
        f.write("  8   6\n  0 0 1.5\n\t1  2\t-2.25\n   7   5    3.125e-2\n"
                "2 3 -1e3\n")
    m, n, b = native.parse_file(p)
    assert (m, n) == (8, 6)
    np.testing.assert_array_equal(b, _numpy_reference(p)[2])


def test_reader_takes_native_path(native, monkeypatch):
    calls = []
    parse = native.parse_file
    monkeypatch.setattr(native, "parse_file",
                        lambda path: calls.append(path) or parse(path))
    monkeypatch.setattr(teuroc, "_native", native)
    monkeypatch.setattr(teuroc, "_native_checked", True)
    m, n, a = teuroc.read_euroc_jacobian(SAMPLE)
    assert calls == [SAMPLE]
    np.testing.assert_array_equal(a, _numpy_reference(SAMPLE)[2])


def test_missing_file(native):
    with pytest.raises(IOError):
        native.parse_file("/nonexistent/file.txt")
