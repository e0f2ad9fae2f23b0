"""The port's binary datasource (``mmlspark_tpu_torch.io.binary`` over
``native/fastio.cc``) against the JAX package's, on the CPU: the directory
scan, the bulk read, the (path, length, modificationTime, bytes) table and
the murmur3 per-file subsample equal the reference's, and the streaming
reader picks up new files once."""

import os
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu import native as rnative
from mmlspark_tpu.featurize.hashing import murmur3_32 as ref_murmur
from mmlspark_tpu.io.binary import read_binary_files as ref_read
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.io.binary import (BinaryFileReader, murmur3_32,
                                          read_binary_files)


@pytest.fixture()
def tree(tmp_path):
    d = tmp_path / "blobs"
    (d / "sub").mkdir(parents=True)
    for i in range(10):
        (d / f"f{i:02d}.bin").write_bytes(bytes([i]) * (100 + i))
    (d / "sub" / "deep.bin").write_bytes(b"deep")
    (d / "sub" / "empty.bin").write_bytes(b"")
    (d / "skip.txt").write_text("no")
    os.symlink(str(d / "sub"), str(d / "link"))   # never followed
    return str(d)


@pytest.mark.parametrize("pattern,recursive", [("*.bin", True),
                                               ("*.bin", False),
                                               (None, True),
                                               ("*.txt", True)])
def test_scan_and_read_equal_the_reference(tree, pattern, recursive):
    ents = native.scan_dir(tree, pattern, recursive)
    assert ents == rnative.scan_dir(tree, pattern, recursive)
    paths = [e[0] for e in ents]
    blobs = native.read_files(paths, n_threads=4)
    assert blobs == rnative.read_files(paths, 4)
    for (p, size, _), b in zip(ents, blobs):
        assert len(b) == size and b == open(p, "rb").read()
    if paths:
        assert native.read_file(paths[0]) == rnative.read_file(paths[0])


def test_scan_of_a_missing_directory_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open directory"):
        native.scan_dir(str(tmp_path / "nope"))
    assert native.read_files([]) == []


@pytest.mark.parametrize("ratio,seed", [(1.0, 0), (0.5, 3), (0.3, 11)])
def test_read_binary_files_equals_the_reference(tree, ratio, seed):
    t = read_binary_files(tree, pattern="*.bin", sample_ratio=ratio,
                          seed=seed)
    r = ref_read(tree, pattern="*.bin", sample_ratio=ratio, seed=seed)
    assert set(t.columns) == set(r.columns)
    for c in ("path", "bytes"):
        assert list(t[c]) == list(r[c])
    for c in ("length", "modificationTime"):
        assert np.array_equal(np.asarray(t[c]), np.asarray(r[c]))
    if ratio < 1.0:
        assert 0 < len(t["path"]) < 12
    t2 = read_binary_files(tree, "*.bin", True, False)
    assert "modificationTime" not in t2.columns


@pytest.mark.parametrize("seed", [0, 42, -7, 2 ** 31 - 1])
def test_murmur3_equals_the_reference(seed):
    terms = ["", "a", "abc", "abcd", "hello world", "ünïcödé", "x" * 1001,
             "/data/blobs/f01.bin"]
    want = [ref_murmur(t.encode("utf-8"), seed) for t in terms]
    assert [murmur3_32(t.encode("utf-8"), seed) for t in terms] == want
    assert native.murmur3_batch(terms, seed) == want
    assert rnative.murmur3_batch(terms, seed) == want


def test_streaming_reader_picks_up_new_files_once(tree):
    r = BinaryFileReader(tree, pattern="*.bin", batch_size=4, follow=True,
                         poll_interval=0.05)
    got = []

    def consume():
        for b in r:
            got.extend(list(b["path"]))
            if any("late" in p for p in list(b["path"])):
                r.stop()

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    time.sleep(0.3)
    with open(os.path.join(tree, "late.bin"), "wb") as f:
        f.write(b"late!")
    th.join(10)
    assert any(p.endswith("late.bin") for p in got)
    assert len(got) == 13                  # 12 at first, 1 late, no dups
    batches = list(BinaryFileReader(tree, pattern="*.bin", batch_size=4))
    assert [len(b["path"]) for b in batches] == [4, 4, 4, 1]
    assert len(list(BinaryFileReader(tree, pattern="*.bin", batch_size=4,
                                     max_batches=2))) == 2
