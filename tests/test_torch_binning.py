"""The port's ``BinMapper`` against the JAX package's: edges, bin ids and
bin upper values must match exactly (the same float64 host arithmetic),
on data with NaNs, ties, a constant column and an all-NaN column. The
port's ``transform`` runs its own C++ (``native/data_plane.cpp``); it is
held bit for bit to its numpy version ``_transform_python`` and to both
of the JAX package's paths (its C++ ``_transform_native`` and its numpy
``_transform_python``)."""

import re

import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.ops.ingest import binned_ingest_dtype as jax_ingest_dtype
from mmlspark_tpu_torch.native import bindings
from mmlspark_tpu_torch.ops import binning as port_binning
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)


def _data(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.empty((n, 7))
    x[:, 0] = rng.normal(size=n)                        # high cardinality
    x[:, 1] = np.round(rng.normal(size=n), 1)           # heavy ties
    x[:, 2] = rng.integers(0, 5, size=n)                # few distinct values
    x[:, 3] = 3.25                                       # constant
    x[:, 4] = np.nan                                     # all missing
    x[:, 5] = rng.exponential(size=n) ** 3               # skewed
    x[:, 6] = rng.normal(size=n)
    x[rng.random((n, 7)) < 0.07] = np.nan                # scattered NaNs
    return x


def _assert_same(port, ref, x):
    assert port.num_features == ref.num_features
    for f in range(ref.num_features):
        np.testing.assert_array_equal(port.upper_edges[f], ref.upper_edges[f])
        assert port.num_bins(f) == ref.num_bins(f)
    assert port.max_num_bins == ref.max_num_bins
    np.testing.assert_array_equal(port.transform(x), ref.transform(x))
    for total in (ref.max_bin, ref.max_num_bins):
        np.testing.assert_array_equal(port.bin_upper_values(total),
                                      ref.bin_upper_values(total))


@pytest.mark.parametrize("max_bin,min_data_in_bin,by_feature", [
    (255, 3, None),
    (63, 3, None),
    (16, 1, None),
    (32, 20, None),
    (255, 3, [8, 0, -1, 300, 4, 2, 16]),
])
def test_fit_transform_match_jax(max_bin, min_data_in_bin, by_feature):
    x = _data()
    kw = dict(max_bin=max_bin, min_data_in_bin=min_data_in_bin,
              max_bin_by_feature=by_feature)
    _assert_same(BinMapper.fit(x[:3000], **kw),
                 JaxBinMapper.fit(x[:3000], **kw), x)


def test_transform_of_values_outside_the_sample():
    x = _data()
    port, ref = BinMapper.fit(x, max_bin=63), JaxBinMapper.fit(x, max_bin=63)
    probe = np.array([[np.inf, -np.inf, 1e300, -1e300, 0.0, np.nan, 3.25],
                      [-0.0, 2.0, 4.0, 3.24, 3.26, 1e-300, -5.0]])
    np.testing.assert_array_equal(port.transform(probe), ref.transform(probe))


def test_transform_blocks_do_not_change_bins(monkeypatch):
    x = _data(n=1000, seed=1)
    mapper = BinMapper.fit(x, max_bin=255)
    whole = mapper.transform(x)
    monkeypatch.setattr(port_binning, "_TRANSFORM_BLOCK_ROWS", 77)
    np.testing.assert_array_equal(mapper.transform(x), whole)
    np.testing.assert_array_equal(
        whole, JaxBinMapper.fit(x, max_bin=255).transform(x))


def test_float32_input_bins_like_jax():
    x = _data(seed=2).astype(np.float32)
    _assert_same(BinMapper.fit(x, max_bin=255),
                 JaxBinMapper.fit(x, max_bin=255), x)


@pytest.mark.parametrize("total_bins", [2, 255, 256, 257, 65536, 65537])
def test_binned_ingest_dtype_matches_jax(total_bins):
    assert binned_ingest_dtype(total_bins) == jax_ingest_dtype(total_bins)


# --- the C++ binning ---------------------------------------------------------

def _edge_case_mappers():
    """(port, JAX) mappers of five features: edges through 0.0 and
    around it, a feature with no edges, a single edge, wide magnitudes,
    and 254 edges (bin ids up to 255, the most uint8 holds)."""
    d = {"max_bin": 255, "upper_edges": [
        [-2.5, -1.0, 0.0, 0.5, 3.0],
        [],
        [1.0],
        [-1e300, -1e-300, 1e-300, 1e300],
        list(np.linspace(-3.0, 3.0, 254))]}
    d["is_categorical"] = [False] * 5
    d["categories"] = [None] * 5
    return BinMapper.from_dict(d), JaxBinMapper.from_dict(d)


def _edge_case_rows(n, dtype, seed=0):
    """``n`` rows: random values, every edge exactly, NaN, +-inf, -0.0
    and +0.0 (against the 0.0 edge) scattered over them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=2.0, size=(n, 5))
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -2.5, -1.0,
                         0.5, 3.0, 1.0, 1e300, -1e-300, 1e-300, 3.0 - 1e-9])
    pick = rng.random((n, 5)) < 0.3
    x[pick] = rng.choice(specials, size=int(pick.sum()))
    if n >= len(specials):
        x[:len(specials), :] = specials[:, None]
    with np.errstate(over="ignore"):    # +-1e300 is +-inf in float32
        return x.astype(dtype)


@pytest.mark.parametrize("n", [1, 7, 4097, 65537])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpp_binning_is_bitwise_numpy_and_jax(n, dtype):
    """1 row and 7 rows bin on the caller's thread, 4,097 on threads,
    65,537 across a block boundary of ``_TRANSFORM_BLOCK_ROWS``."""
    port, ref = _edge_case_mappers()
    x = _edge_case_rows(n, dtype)
    got = port.transform(x)
    assert got.dtype == np.int32 and got.shape == x.shape
    x64 = x.astype(np.float64)
    np.testing.assert_array_equal(got, port._transform_python(x64))
    np.testing.assert_array_equal(got, ref._transform_python(x64))
    native = ref._transform_native(x64)
    assert native is not None, "the JAX package's C++ library is missing"
    np.testing.assert_array_equal(got, native)
    np.testing.assert_array_equal(got, ref.transform(x))
    # the edge cases land where they should
    assert (got[np.isnan(x)] == 0).all()
    assert (got[x == np.inf] == np.array(
        [port.num_bins(f) - 1 for f in range(5)])[
            np.nonzero(x == np.inf)[1]]).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_narrow_bin_ids_are_the_int32_ids_cast(dtype):
    port, _ = _edge_case_mappers()
    x = _edge_case_rows(5000, np.float64, seed=3)
    wide = port.transform(x)
    got = port.transform(x, dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, wide.astype(dtype))
    assert wide.max() == 255


def test_bin_ids_that_do_not_fit_the_dtype_raise():
    x = _data(n=3000)
    mapper = BinMapper.fit(x, max_bin=1024, min_data_in_bin=1)
    assert mapper.max_num_bins > 256
    with pytest.raises(ValueError, match="do not fit"):
        mapper.transform(x, np.uint8)
    np.testing.assert_array_equal(mapper.transform(x, np.uint16),
                                  mapper.transform(x).astype(np.uint16))


def test_other_inputs_bin_as_float64():
    """Integer, float16 and non-contiguous rows are converted block by
    block; the ids equal the numpy version's on the float64 values."""
    x = _data(n=2000, seed=4)
    mapper = BinMapper.fit(x, max_bin=63)
    for v in (np.round(x * 3).astype(np.float16),
              np.nan_to_num(np.round(x * 3)).astype(np.int64),
              np.asfortranarray(x), x[::2]):
        np.testing.assert_array_equal(
            mapper.transform(v),
            mapper._transform_python(np.asarray(v, dtype=np.float64)))


def test_feature_count_mismatch_raises():
    x = _data(n=500)
    mapper = BinMapper.fit(x, max_bin=63)
    with pytest.raises(ValueError, match="features"):
        mapper.transform(x[:, :5])
    with pytest.raises(ValueError, match="features"):
        mapper.transform(x[:, 0])


def test_padded_edges_are_built_once():
    port, _ = _edge_case_mappers()
    first = port._padded_edges()
    assert port._padded_edges() is first
    assert first.shape == (5, 255) and np.isinf(first[1]).all()


def test_host_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    path = bindings.host_library_path("data_plane", tmp_path)
    assert path.parent == tmp_path and path.name.startswith(
        "libdata_plane-host-")
    assert bindings.host_library_path("data_plane", tmp_path) == path
    monkeypatch.setattr(bindings, "HOST_FLAGS",
                        bindings.HOST_FLAGS + ("-g",))
    assert bindings.host_library_path("data_plane", tmp_path) != path
    built = bindings.build_host("data_plane", build_dir=tmp_path)
    assert built.exists() and built.name != path.name
    assert "-march=native" not in bindings.HOST_FLAGS


def test_failed_host_build_raises_naming_the_source(tmp_path):
    missing = str(tmp_path / "no-such-compiler" / "g++")
    with pytest.raises(RuntimeError, match="data_plane.cpp"):
        bindings.build_host("data_plane", compiler=missing,
                            build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_failed_compile_raises_with_the_compiler_output(tmp_path):
    with pytest.raises(RuntimeError, match="data_plane.cpp.*exit"):
        bindings.build_host("data_plane", compiler="false",
                            build_dir=tmp_path)


def test_bin_matrix_refuses_what_the_library_does_not_take():
    edges = np.full((2, 3), np.inf)
    vals = np.zeros((4, 2))
    out = np.empty((4, 2), np.int32)
    for bad in ((vals.astype(np.int64), edges, out),
                (vals, edges, out.astype(np.int64)),
                (vals, edges[:1], out),
                (np.asfortranarray(np.zeros((4, 2))), edges, out)):
        with pytest.raises(ValueError):
            bindings.bin_matrix(*bad)
    bindings.bin_matrix(vals, edges, out)
    np.testing.assert_array_equal(out, 1)


def test_host_source_includes_only_system_headers():
    """The port's C++ is its own copy: it includes no file of the JAX
    package's ``native/`` (nor any local header)."""
    src = (bindings.NATIVE / "data_plane.cpp").read_text()
    includes = re.findall(r"^\s*#\s*include\s*(\S+)", src, re.M)
    assert includes and all(i.startswith("<") for i in includes), includes
    assert "native/" not in "".join(includes)
