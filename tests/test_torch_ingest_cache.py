"""Dataset caches: lightgbm_tpu_torch's writers and readers (device="cpu")
against lightgbm_tpu's, on the same files.

- the native cache (magic, pickled header, raw matrix) and the
  reference-format cache are byte-equal between the packages (``cmp``),
  with and without in-file weights and queries, and each package reads
  the other's into the same dataset;
- ``load_train``'s dispatch: a cache as ``data=``, a ``<data>.bin``
  sibling (ours, corrupt, foreign), a foreign ``.bin`` never
  overwritten, a streamed read of a cache;
- ``task=predict`` on a cache writes the JAX CLI's result file, and the
  text file's.

Tolerance: none.  Sizes: 1,200-3,000 rows, 5 features.
"""
import filecmp
import os
import shutil

import pytest

from lightgbm_tpu.cli import main as jcli
from lightgbm_tpu.config import IOConfig as JIOConfig
from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.utils.log import LightGBMError as JError

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.cli import main as tcli
from lightgbm_tpu_torch.config import IOConfig
from lightgbm_tpu_torch.io import streaming
from lightgbm_tpu_torch.utils import log

from test_torch_ingest_columns import assert_same_dataset, write_table

LAYOUTS = {
    "plain": {},
    "weights": {"label_column": "name:y", "weight_column": "name:w",
                "ignore_column": "name:q"},
    "queries": {"label_column": "name:y", "group_column": "name:q"},
    "weights-queries": {"label_column": "name:y", "weight_column": "name:w",
                        "group_column": "name:q"},
}


def _twin_files(tmp_path, n=1200, **kw):
    """The same table in two directories (each package writes its own
    ``<data>.bin``)."""
    paths = []
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name, exist_ok=True)
        paths.append(write_table(tmp_path / name / "t.csv", n=n, **kw))
    return paths


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_caches_byte_equal_to_jax(tmp_path, fmt, layout):
    jpath, tpath = _twin_files(tmp_path)
    kw = dict(LAYOUTS[layout], has_header=True, is_save_binary_file=True,
              save_binary_format=fmt, streaming="false")
    j = JDataset.load_train(JIOConfig(data_filename=jpath, **kw))
    t = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    assert_same_dataset(j, t)
    assert filecmp.cmp(jpath + ".bin", tpath + ".bin", shallow=False)
    if fmt == "reference":
        with open(tpath + ".bin", "rb") as f:
            assert f.read(8) != b"LGBM_TPU"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_each_package_reads_the_others_cache(tmp_path, fmt, layout):
    """A cache written by one package, read as a sibling by the other:
    the text load's dataset either way."""
    jpath, tpath = _twin_files(tmp_path)
    kw = dict(LAYOUTS[layout], has_header=True, streaming="false")
    j = JDataset.load_train(JIOConfig(data_filename=jpath, **kw))
    t = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    if fmt == "native":
        j.save_binary(tpath + ".bin")
        t.save_binary(jpath + ".bin")
    else:
        j.save_binary_reference(tpath + ".bin")
        t.save_binary_reference(jpath + ".bin")
    t_from_j = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    j_from_t = JDataset.load_train(JIOConfig(data_filename=jpath, **kw))
    assert_same_dataset(j_from_t, t_from_j)
    assert_same_dataset(j, t_from_j)
    assert t_from_j.bins is not None and t_from_j.device_bins is None


def test_direct_cache_as_data(tmp_path):
    """``data=`` a native cache: no text file needed, either package's."""
    jpath, tpath = _twin_files(tmp_path)
    j = JDataset.load_train(JIOConfig(data_filename=jpath, has_header=True))
    j.save_binary(str(tmp_path / "direct.bin"))
    os.unlink(jpath)
    os.unlink(tpath)
    t = lgt.Dataset.load_train(IOConfig(
        data_filename=str(tmp_path / "direct.bin")))
    assert_same_dataset(j, t)
    # the default label is column 0, "a"
    assert t.feature_names == ["b", "y", "w", "q", "c", "d"]


def test_streamed_cache_read_equals_resident(tmp_path):
    """``streaming=true`` on a cache: its memmapped matrix fed to the
    device writer in row chunks (an odd tail) gives the same dataset."""
    _, tpath = _twin_files(tmp_path, n=3001)
    kw = dict(LAYOUTS["weights-queries"], has_header=True)
    t = lgt.Dataset.load_train(IOConfig(data_filename=tpath,
                                        is_save_binary_file=True, **kw))
    s = lgt.Dataset.load_train(
        IOConfig(data_filename=tpath + ".bin", streaming="true",
                 ingest_chunk_rows=700, **kw), device="cpu")
    assert s.bins is None and s.device_bins is not None
    assert s.ingest_writer.h2d_bytes == t.bins.nbytes
    assert_same_dataset(t, s)


@pytest.mark.parametrize("where", ["direct", "sibling"])
def test_corrupt_cache_is_fatal(tmp_path, where):
    _, tpath = _twin_files(tmp_path)
    bad = tpath + ".bin" if where == "sibling" else str(tmp_path / "x.bin")
    with open(bad, "wb") as f:
        f.write(b"LGBM_TPU_BIN" + b"\0" * 64)
    data = tpath if where == "sibling" else bad
    with pytest.raises(JError, match="corrupt/truncated"):
        JDataset.load_train(JIOConfig(data_filename=data))
    with pytest.raises(log.Fatal, match="corrupt/truncated"):
        lgt.Dataset.load_train(IOConfig(data_filename=data))


def test_damaged_native_cache_is_fatal(tmp_path):
    path = str(tmp_path / "d.bin")
    with open(path, "wb") as f:
        f.write(b"LGBM_TPU_BIN_V1" + (99).to_bytes(8, "little") + b"junk")
    with pytest.raises(log.Fatal, match="damaged lightgbm_tpu cache"):
        lgt.Dataset.load_train(IOConfig(data_filename=path))


def test_foreign_sibling_never_overwritten(tmp_path):
    """An unreadable foreign ``.bin`` beside the data: re-binned from the
    text, a warning, and the file left as it was, even with
    ``is_save_binary_file``."""
    jpath, tpath = _twin_files(tmp_path)
    junk = b"\x07" * 40
    for path in (jpath, tpath):
        with open(path + ".bin", "wb") as f:
            f.write(junk)
    kw = dict(has_header=True, is_save_binary_file=True)
    j = JDataset.load_train(JIOConfig(data_filename=jpath, **kw))
    t = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    assert_same_dataset(j, t)
    with open(tpath + ".bin", "rb") as f:
        assert f.read() == junk
    # the same under streaming, whose cache writer runs in pass 2
    s = lgt.Dataset.load_train(IOConfig(data_filename=tpath,
                                        streaming="true", **kw),
                               device="cpu")
    assert_same_dataset(j, s)
    with open(tpath + ".bin", "rb") as f:
        assert f.read() == junk


def test_foreign_sibling_without_text_is_fatal(tmp_path):
    path = str(tmp_path / "gone.csv")
    with open(path + ".bin", "wb") as f:
        f.write(b"\x01" * 16)
    with pytest.raises(log.Fatal, match="neither a lightgbm_tpu cache"):
        lgt.Dataset.load_train(IOConfig(data_filename=path))


def test_reference_cache_label_column_recovered(tmp_path):
    """A reference cache keeps the labels, not their column: a
    ``label_column`` comes back from the text header."""
    _, tpath = _twin_files(tmp_path)
    kw = dict(LAYOUTS["weights"], has_header=True)
    t = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    t.save_binary_reference(tpath + ".bin")
    r = lgt.Dataset.load_train(IOConfig(data_filename=tpath, **kw))
    assert r.label_idx == t.label_idx == 2
    j = JDataset.load_train(JIOConfig(data_filename=tpath, **kw))
    assert_same_dataset(j, r)


def test_streamed_dataset_refuses_host_writers(tmp_path):
    _, tpath = _twin_files(tmp_path)
    s = lgt.Dataset.load_train(IOConfig(data_filename=tpath,
                                        streaming="true"), device="cpu")
    with pytest.raises(log.Fatal, match="host-resident bin matrix"):
        s.save_binary(str(tmp_path / "s.bin"))
    with pytest.raises(log.Fatal, match="host-resident bin matrix"):
        s.save_binary_reference(str(tmp_path / "s.bin"))


def test_predict_on_cache_equals_jax_cli(tmp_path):
    """``task=predict`` with ``data=`` a native cache: the port's result
    file is the JAX CLI's on the same cache, and the text file's."""
    _, tpath = _twin_files(tmp_path, n=2000)
    model = str(tmp_path / "model.txt")
    assert tcli(["task=train", "data=" + tpath, "has_header=true",
                 "label_column=name:y", "objective=binary",
                 "num_trees=3", "num_leaves=7", "is_save_binary_file=true",
                 "output_model=" + model, "device=cpu"]) == 0
    cache = str(tmp_path / "cache.bin")
    shutil.move(tpath + ".bin", cache)
    outs = {}
    for name, main, extra, data in (
            ("jax", jcli, [], cache),
            ("port", tcli, ["device=cpu"], cache),
            ("text", tcli, ["device=cpu", "has_header=true",
                            "label_column=name:y"], tpath)):
        out = str(tmp_path / ("%s.out" % name))
        assert main(["task=predict", "data=" + data, "input_model=" + model,
                     "output_result=" + out] + extra) == 0
        with open(out) as f:
            outs[name] = f.read()
    assert outs["port"] == outs["jax"] == outs["text"]
    assert len(outs["port"].splitlines()) == 2000


def test_resolve_streaming_rule(tmp_path):
    path = str(tmp_path / "f")
    with open(path, "wb") as f:
        f.truncate(streaming.AUTO_MIN_BYTES - 1)
    for mode, want in (("auto", False), ("true", True), ("false", False)):
        assert streaming.resolve_streaming(IOConfig(streaming=mode),
                                           path) is want
    with open(path, "ab") as f:
        f.write(b"\0")
    assert streaming.resolve_streaming(IOConfig(streaming="auto"), path)
    assert not streaming.resolve_streaming(IOConfig(streaming="auto"),
                                           path + ".missing")
