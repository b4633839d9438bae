"""The port's spill plane (``ops/ingest.py``), quantile sketch
(``ops/sketch.py``) and ``BinMapper.fit_streaming`` against the JAX
package's, on the CPU.

Tolerances: none. Frames are byte for byte the reference's, a spill
written by either package reads back through the other's reader, the
sketch's items, rank-error bound and quantiles are bit for bit the
reference's, and ``fit_streaming``'s edges equal the reference's (and
``BinMapper.fit``'s under the tally cap) bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.ops import ingest as jax_ingest
from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu.ops.sketch import QuantileSketch as JaxSketch
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.serialize import DiskFull
from mmlspark_tpu_torch.ops import ingest
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.sketch import DEFAULT_SKETCH_K, QuantileSketch

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    faults.reset()
    jax_faults.reset()
    for name in ("MMLSPARK_TORCH_SPILL_VERIFY", "MMLSPARK_TPU_SPILL_VERIFY"):
        monkeypatch.delenv(name, raising=False)
    yield
    faults.reset()
    jax_faults.reset()


def _arrays():
    rng = np.random.default_rng(7)
    return {
        "uint8": rng.integers(0, 256, size=(33, 5)).astype(np.uint8),
        "uint16": rng.integers(0, 65536, size=(17, 3)).astype(np.uint16),
        "int16": rng.integers(-32000, 32000, size=(41,)).astype(np.int16),
        "float32": rng.normal(size=(9, 4)).astype(np.float32),
    }


# --- frames -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "float32"])
def test_pack_frame_bytes_equal_the_reference(dtype):
    """Bitwise: the same frame bytes for every dtype the plane stores."""
    arr = _arrays()[dtype]
    assert ingest.pack_frame(arr) == jax_ingest.pack_frame(arr)
    # a non-contiguous view frames as its contiguous copy, in both
    view = arr[::2]
    assert ingest.pack_frame(view) == jax_ingest.pack_frame(view)


def test_binned_ingest_dtype_is_the_reference():
    for bins in (2, 255, 256, 257, 1023, 65536, 65537):
        assert ingest.binned_ingest_dtype(bins) == \
            jax_ingest.binned_ingest_dtype(bins)


def _write_spill(mod, path, chunks, dtype=np.uint8):
    writer = mod.SpillWriter(str(path), dtype=dtype)
    for c in chunks:
        writer.append(c)
    return writer.finalize()


def _chunks(dtype=np.uint8, hi=200):
    rng = np.random.default_rng(3)
    return [rng.integers(0, hi, size=(r, 6)).astype(dtype)
            for r in (100, 57, 100)]


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_spill_crosses_packages_both_ways(tmp_path, writer, reader, dtype):
    """Bitwise: a spill written by one package reads back through the
    other's ``SpillReader``, every chunk and the manifest."""
    mods = {"port": ingest, "jax": jax_ingest}
    chunks = _chunks(dtype, hi=1000 if dtype == np.uint16 else 200)
    _write_spill(mods[writer], tmp_path / "s", chunks, dtype)
    spill = mods[reader].SpillReader(str(tmp_path / "s"))
    assert spill.chunk_rows == [100, 57, 100]
    assert spill.offsets == [0, 100, 157]
    assert spill.total_rows == 257 and spill.n_features == 6
    assert spill.dtype == np.dtype(dtype)
    for i, want in enumerate(chunks):
        got = spill.read(i)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [c.tolist() for c in spill] == [c.tolist() for c in chunks]
    # the directories are byte for byte the same
    other = mods["jax" if writer == "port" else "port"]
    _write_spill(other, tmp_path / "t", chunks, dtype)
    for name in sorted(os.listdir(tmp_path / "s")):
        assert (tmp_path / "s" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name


def test_chunk_store_crosses_packages(tmp_path):
    arr = _arrays()["int16"]
    ingest.ChunkStore(str(tmp_path), "gq").put(3, arr)
    np.testing.assert_array_equal(
        jax_ingest.ChunkStore(str(tmp_path), "gq").get(3), arr)
    jax_ingest.ChunkStore(str(tmp_path), "hq").put(0, arr[::-1])
    np.testing.assert_array_equal(
        ingest.ChunkStore(str(tmp_path), "hq").get(0), arr[::-1])


def test_writer_refuses_bad_chunks(tmp_path):
    writer = ingest.SpillWriter(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="2-d"):
        writer.append(np.zeros(4, np.uint8))
    writer.append(np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="expected 3"):
        writer.append(np.zeros((4, 2), np.uint8))
    writer.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        writer.append(np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match="no chunks"):
        ingest.SpillWriter(str(tmp_path / "empty")).finalize()


# --- corruption ---------------------------------------------------------------

def _damage(path, how):
    blob = bytearray(path.read_bytes())
    if how == "truncation":
        path.write_bytes(bytes(blob[:-7]))
    elif how == "bad_magic":
        blob[0:4] = b"XXXX"
        path.write_bytes(bytes(blob))
    elif how == "torn_header":
        blob[9] = ord("#")
        path.write_bytes(bytes(blob))
    elif how == "crc_mismatch":
        blob[-1] ^= 0x01
        path.write_bytes(bytes(blob))
    elif how == "missing_file":
        path.unlink()


@pytest.mark.parametrize("how,match", [
    ("truncation", "truncated payload"), ("bad_magic", "not a framed"),
    ("torn_header", "torn frame header"), ("crc_mismatch", "crc32 mismatch"),
    ("missing_file", "missing or unreadable")])
def test_every_corruption_names_the_chunk(tmp_path, how, match):
    """Each structural or checksum failure raises ``SpillCorrupt`` with
    the chunk's index and path, as the reference's does."""
    _write_spill(ingest, tmp_path / "s", _chunks())
    target = tmp_path / "s" / "chunk_000001.bin"
    _damage(target, how)
    for mod in (ingest, jax_ingest):
        spill = mod.SpillReader(str(tmp_path / "s"))
        with pytest.raises(mod.SpillCorrupt, match=match) as info:
            spill.read(1)
        assert info.value.chunk == 1
        assert info.value.path == str(target)
        assert "spill chunk 1" in str(info.value)
        np.testing.assert_array_equal(spill.read(0), _chunks()[0])


def test_unsealed_spill_raises(tmp_path):
    with pytest.raises(ingest.SpillCorrupt, match="never sealed"):
        ingest.SpillReader(str(tmp_path))


def test_manifest_shape_mismatch_raises(tmp_path):
    _write_spill(ingest, tmp_path / "s", _chunks())
    ingest.write_chunk(str(tmp_path / "s" / "chunk_000002.bin"),
                       np.zeros((3, 6), np.uint8))
    with pytest.raises(ingest.SpillCorrupt, match="manifest says") as info:
        ingest.SpillReader(str(tmp_path / "s")).read(2)
    assert info.value.chunk == 2


def _flip_first(payload):
    b = bytearray(payload)
    b[0] ^= 0xFF
    return bytes(b)


def test_spill_read_corrupt_fault_is_caught_like_bit_rot(tmp_path):
    """The ``spill.read`` fault's ``corrupt`` action changes the payload
    before the checksum: the reader raises as for real bit rot; the
    file itself is intact, so the next read passes."""
    spill = _write_spill(ingest, tmp_path / "s", _chunks())
    with faults.injected("spill.read", "corrupt", nth=1, count=1,
                         corrupt=_flip_first):
        with pytest.raises(ingest.SpillCorrupt, match="crc32 mismatch"):
            spill.read(0)
        np.testing.assert_array_equal(spill.read(0), _chunks()[0])
    # under verify=off the corrupt bytes are trusted
    store = ingest.ChunkStore(str(tmp_path / "w"), "carry")
    store.put(0, np.arange(8, dtype=np.uint8))
    store.verify_mode = "off"
    with faults.injected("spill.read", "corrupt", nth=1, count=1,
                         corrupt=_flip_first):
        assert store.get(0)[0] == 0xFF


def test_disk_full_raises_disk_full(tmp_path):
    """``io.disk_full`` on a spill write is the attributed ``DiskFull``
    (an OSError), for the writer, a chunk store and a repair."""
    spill = _write_spill(ingest, tmp_path / "s", _chunks())
    writer = ingest.SpillWriter(str(tmp_path / "t"))
    store = ingest.ChunkStore(str(tmp_path / "w"), "node")
    for write in (lambda: writer.append(np.zeros((2, 2), np.uint8)),
                  lambda: store.put(0, np.zeros(2, np.int32)),
                  lambda: spill.repair(0, _chunks()[0])):
        with faults.injected("io.disk_full", "raise"):
            with pytest.raises(DiskFull, match=r"\[io.disk_full\]"):
                write()
    # a real OSError (a directory in the file's place) is DiskFull too
    os.makedirs(tmp_path / "x" / "c.bin.tmp")
    with pytest.raises(DiskFull, match="IsADirectoryError"):
        ingest.write_chunk(str(tmp_path / "x" / "c.bin"), np.zeros(1))


# --- verification modes -----------------------------------------------------

@pytest.mark.parametrize("mode,checks", [("auto", 3), ("on", 6), ("off", 0)])
def test_verify_modes_and_counters(tmp_path, monkeypatch, mode, checks):
    """auto verifies each chunk's first read, on every read, off none;
    ``verify_chunks`` counts them and ``verify_s`` their seconds. A
    chunk store re-verifies an entry's first read after each put."""
    monkeypatch.setenv("MMLSPARK_TORCH_SPILL_VERIFY", mode)
    spill = _write_spill(ingest, tmp_path / "s", _chunks())
    assert spill.verify_mode == mode
    for _ in range(2):
        for i in range(3):
            spill.read(i)
    assert spill.verify_chunks == checks
    assert (spill.verify_s > 0) == (checks > 0)
    store = ingest.ChunkStore(str(tmp_path / "w"), "carry")
    store.put(0, np.zeros(4, np.float32))
    store.get(0)
    store.get(0)
    store.put(0, np.ones(4, np.float32))
    store.get(0)
    assert store.verify_chunks == {"auto": 2, "on": 3, "off": 0}[mode]


def test_bad_verify_mode_warns_once_and_runs_auto(monkeypatch, caplog):
    from mmlspark_tpu_torch.core.logging_utils import reset_warn_once
    reset_warn_once()
    monkeypatch.setenv("MMLSPARK_TORCH_SPILL_VERIFY", "sometimes")
    assert [ingest.resolve_spill_verify() for _ in range(2)] == ["auto"] * 2
    assert sum("sometimes" in r.getMessage() for r in caplog.records) == 1


def test_repair_rewrites_a_chunk_bitwise(tmp_path):
    chunks = _chunks()
    spill = _write_spill(ingest, tmp_path / "s", chunks)
    _damage(tmp_path / "s" / "chunk_000002.bin", "crc_mismatch")
    with pytest.raises(ingest.SpillCorrupt):
        spill.read(2)
    with pytest.raises(ValueError, match="expects"):
        spill.repair(2, chunks[2][:5])
    spill.repair(2, chunks[2].astype(np.int32))
    assert spill.repairs == 1
    np.testing.assert_array_equal(spill.read(2), chunks[2])
    # the rewritten file is the original frame
    assert (tmp_path / "s" / "chunk_000002.bin").read_bytes() == \
        ingest.pack_frame(chunks[2])


# --- the quantile sketch ------------------------------------------------------

def _streams():
    rng = np.random.default_rng(11)
    heavy = rng.standard_cauchy(30_000)
    heavy[::97] = np.nan
    return {
        "normal": [rng.normal(size=s) for s in (5_000, 1, 17_000, 333)],
        "heavy_nan": np.array_split(heavy, 5),
        "ties": [rng.integers(0, 40, size=6_000).astype(np.float64)
                 for _ in range(3)],
        "sorted": [np.arange(s, s + 9_000, dtype=np.float64)
                   for s in range(0, 27_000, 9_000)],
    }


def _same_sketch(a, b):
    ua, wa = a.items()
    ub, wb = b.items()
    np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(wa, wb)
    assert a.rank_error() == b.rank_error()
    assert (a.n, a.vmin, a.vmax) == (b.n, b.vmin, b.vmax)
    qs = np.linspace(0.0, 1.0, 41)
    np.testing.assert_array_equal(a.quantiles(qs), b.quantiles(qs))
    assert a.quantile(0.5) == b.quantile(0.5)
    assert a.rank(0.25) == b.rank(0.25)


@pytest.mark.parametrize("name", ["normal", "heavy_nan", "ties", "sorted"])
@pytest.mark.parametrize("k", [64, DEFAULT_SKETCH_K])
def test_sketch_is_the_reference_bit_for_bit(name, k):
    """Items, rank_error and quantiles bit for bit, fed chunk by chunk
    (unmerged) and as sketches of each chunk merged together."""
    chunks = _streams()[name]
    port, ref = QuantileSketch(k), JaxSketch(k)
    for c in chunks:
        port.update(c)
        ref.update(c)
    _same_sketch(port, ref)
    pm, rm = QuantileSketch(k), JaxSketch(k)
    for c in chunks:
        ps, rs = QuantileSketch(k), JaxSketch(k)
        ps.update(c)
        rs.update(c)
        pm.merge(ps)
        rm.merge(rs)
    _same_sketch(pm, rm)
    # the analytic bound holds against the exact ranks
    flat = np.concatenate([np.asarray(c).ravel() for c in chunks])
    flat = np.sort(flat[~np.isnan(flat)])
    for q in (0.1, 0.5, 0.9):
        v = port.quantile(q)
        true_rank = np.searchsorted(flat, v, side="right")
        assert abs(port.rank(v) - true_rank) <= port.rank_error()


def test_sketch_refusals():
    with pytest.raises(ValueError, match="k must be >= 8"):
        QuantileSketch(4)
    with pytest.raises(ValueError, match="cannot merge"):
        QuantileSketch(16).merge(QuantileSketch(32))
    empty = QuantileSketch()
    assert np.isnan(empty.quantiles([0.5])).all()
    assert len(empty) == 0


# --- fit_streaming ------------------------------------------------------------

def _columns(n=6_000):
    rng = np.random.default_rng(5)
    x = np.empty((n, 5))
    x[:, 0] = rng.normal(size=n)                      # high cardinality
    x[:, 1] = rng.integers(0, 7, size=n)              # low cardinality
    x[:, 2] = np.round(rng.normal(size=n), 2)         # ~600 values
    x[:, 3] = 1.5                                     # constant
    x[:, 4] = np.where(rng.random(n) < 0.2, np.nan,
                       np.round(rng.normal(size=n), 1))
    return x


def _edges_equal(a, b):
    assert len(a.upper_edges) == len(b.upper_edges)
    for ea, eb in zip(a.upper_edges, b.upper_edges):
        assert ea.dtype == eb.dtype
        np.testing.assert_array_equal(ea, eb)


@pytest.mark.parametrize("max_bin,bbf", [(63, None), (255, None),
                                         (1023, None), (255, [16, 0, 8])])
def test_fit_streaming_edges_equal_the_reference(max_bin, bbf):
    """High-cardinality columns past the tally cap take the sketch's
    items, the others the exact tally: every edge bit for bit the
    reference's."""
    x = _columns()
    parts = [x[:1_000], x[1_000:1_001], x[1_001:4_500], x[4_500:]]
    port = BinMapper.fit_streaming(iter(parts), max_bin=max_bin,
                                   max_bin_by_feature=bbf, sketch_k=256)
    ref = JaxBinMapper.fit_streaming(iter(parts), max_bin=max_bin,
                                     max_bin_by_feature=bbf, sketch_k=256)
    _edges_equal(port, ref)
    assert port.max_bin == max_bin and not port.is_categorical.any()
    # column 0 (6,000 distinct values) passed the cap and took the
    # sketch; the others kept the tally, so their edges are fit's
    full = BinMapper.fit(x, max_bin=max_bin, max_bin_by_feature=bbf)
    for f in (1, 2, 3, 4):
        np.testing.assert_array_equal(port.upper_edges[f],
                                      full.upper_edges[f])


def test_fit_streaming_equals_fit_under_the_tally_cap():
    """Bitwise: with every column under ``max(4096, 4 * usable)`` distinct
    values, the streamed edges are ``fit``'s over the whole rows."""
    rng = np.random.default_rng(9)
    x = np.round(rng.normal(size=(9_000, 4)) * 300) / 100
    x[::13, 2] = np.nan
    parts = np.array_split(x, 7)
    for max_bin in (15, 255, 511):
        _edges_equal(BinMapper.fit_streaming(iter(parts), max_bin=max_bin),
                     BinMapper.fit(x, max_bin=max_bin))


def test_fit_streaming_refusals():
    with pytest.raises(ValueError, match="numeric features only"):
        BinMapper.fit_streaming(iter([np.zeros((4, 2))]),
                                categorical_features=[0])
    with pytest.raises(ValueError, match="at least one chunk"):
        BinMapper.fit_streaming(iter([]))
    with pytest.raises(ValueError, match="2-d"):
        BinMapper.fit_streaming(iter([np.zeros(4)]))
    with pytest.raises(ValueError, match="expected 2"):
        BinMapper.fit_streaming(iter([np.zeros((4, 2)), np.zeros((4, 3))]))
