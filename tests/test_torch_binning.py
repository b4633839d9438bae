"""The port's ``BinMapper`` against the JAX package's: edges, bin ids and
bin upper values must match exactly (the same float64 host arithmetic),
on data with NaNs, ties, a constant column and an all-NaN column."""

import numpy as np
import pytest

from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.ops.ingest import binned_ingest_dtype as jax_ingest_dtype
from mmlspark_tpu_torch.ops import binning as port_binning
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype


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


def test_categorical_features_are_a_later_slice():
    with pytest.raises(NotImplementedError, match="categorical"):
        BinMapper.fit(_data(n=100), categorical_features=[2])


@pytest.mark.parametrize("total_bins", [2, 255, 256, 257, 65536, 65537])
def test_binned_ingest_dtype_matches_jax(total_bins):
    assert binned_ingest_dtype(total_bins) == jax_ingest_dtype(total_bins)
