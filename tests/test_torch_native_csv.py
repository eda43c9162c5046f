"""The port's native CSV reader on the CPU, against the JAX package's.

The JAX reader is built into a private cache (``MMC_NATIVE_CACHE`` at a
temporary directory, its module state reset), never its shared default
one, where concurrent cold builds can clobber each other and its loader
then falls back to numpy. Held bit for bit to it: every case of
``tests/test_native_csv.py``'s ``CASES`` (read from that file, not
imported: importing it would build the JAX reader into the shared cache),
the many-files call, and the H36M corpus read by both packages' datasets.
Also: ragged, garbage and missing files give None; four processes building
from one cold directory all load; a failed build raises with the
compiler's output; a file the native reader refuses goes to numpy.
"""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from motionmixerconv_tpu._native import build as jax_native
from motionmixerconv_tpu.data import h36m as jax_h36m
from motionmixerconv_tpu_torch._native import build as native
from motionmixerconv_tpu_torch._native import (read_csv_many_native,
                                               read_csv_native)
from motionmixerconv_tpu_torch.data import fixtures, h36m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cases() -> dict:
    """``CASES`` of ``tests/test_native_csv.py``, evaluated from its
    source."""
    path = os.path.join(REPO, "tests", "test_native_csv.py")
    tree = ast.parse(open(path).read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "CASES")
    ns = {"np": np}
    exec(compile(ast.Module([node], type_ignores=[]), path, "exec"), ns)
    return ns["CASES"]


CASES = _jax_cases()
# the synthetic corpora's format (fixtures, fmt="%.6f") and a few more forms
MORE = {
    "fixture.txt": "\n".join(
        ",".join(f"{v:.6f}" for v in row)
        for row in np.random.RandomState(5).randn(40, 99) * 300.0) + "\n",
    "forms.txt": ".5,-.25,+3.,1E2\n-0.0,123456789.125,7e-40,3.4e38\n",
    "spaces.txt": "1.0, 2.0 ,3.0\n  4.0,5.0,\t6.0\n",
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv_corpus")
    paths = {}
    for name, text in {**CASES, **MORE}.items():
        (d / name).write_text(text)
        paths[name] = str(d / name)
    return paths


@pytest.fixture
def jax_reader(tmp_path, monkeypatch):
    """The JAX package's reader, built into a private cache."""
    monkeypatch.setenv("MMC_NATIVE_CACHE", str(tmp_path / "jax_native"))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert jax_native.load_csv_reader() is not None, "the JAX build failed"
    yield jax_native
    jax_native._LIB, jax_native._TRIED = None, False


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", sorted({**CASES, **MORE}))
def test_bit_identical_to_the_jax_reader(corpus, jax_reader, name):
    got = read_csv_native(corpus[name])
    want = jax_reader.read_csv_native(corpus[name])
    assert got is not None and want is not None
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_within_the_jax_tolerance_of_numpy(corpus, name):
    """tests/test_native_csv.py's bound against np.loadtxt (1e-6 of the
    largest magnitude)."""
    got = read_csv_native(corpus[name])
    want = np.loadtxt(corpus[name], delimiter=",", dtype=np.float32,
                      ndmin=2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("text", ["1.0,2.0\n3.0\n", "1.0,abc\n", "", "\n\n"])
def test_refused_files_give_none(tmp_path, jax_reader, text):
    """Ragged, garbage, empty and blank files: None, as the JAX reader."""
    p = tmp_path / "bad.txt"
    p.write_text(text)
    assert read_csv_native(str(p)) is None
    assert jax_reader.read_csv_native(str(p)) is None


def test_many_matches_single_and_the_jax_reader(corpus, tmp_path,
                                                jax_reader):
    paths = [corpus[n] for n in sorted(corpus)]
    paths.insert(2, str(tmp_path / "missing.txt"))
    many = read_csv_many_native(paths)
    want = jax_reader.read_csv_many_native(paths)
    assert len(many) == len(paths) and many[2] is None and want[2] is None
    for p, arr, w in zip(paths, many, want):
        if arr is not None:
            np.testing.assert_array_equal(_bits(arr), _bits(read_csv_native(p)))
            np.testing.assert_array_equal(_bits(arr), _bits(w))
    assert read_csv_many_native([]) == []


def test_missing_file_gives_none(tmp_path):
    assert read_csv_native(str(tmp_path / "missing.txt")) is None


_LOADER = textwrap.dedent("""
    import sys
    from pathlib import Path
    sys.path.insert(0, sys.argv[1])
    from motionmixerconv_tpu_torch._native import build
    build.BUILD_DIR = Path(sys.argv[2])
    arr = build.read_csv_native(sys.argv[3])
    print(arr.shape, float(arr.sum()))
""")


def test_concurrent_cold_builds_all_load(tmp_path, corpus):
    """Four processes build from one cold directory at once: each loads
    the one library and reads the file, and no temporary file is left."""
    build_dir = tmp_path / "native"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOADER, REPO, str(build_dir),
         corpus["plain.txt"]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "(2, 3) 1000.625", out
    files = sorted(f for f in os.listdir(build_dir) if f != ".lock")
    assert len(files) == 1 and files[0].endswith(".so"), files


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A compiler that fails: load_csv_reader raises with its output (no
    fallback to numpy, no library left behind); a later call retries."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'fatal: no toolchain here' >&2\nexit 3\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="(?s)exit 3.*no toolchain"):
            native.load_csv_reader()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            read_csv_native(str(tmp_path / "x.txt"))
    assert [f for f in os.listdir(tmp_path / "native") if f != ".lock"] == []


def test_a_refused_file_goes_to_numpy(tmp_path):
    """read_csv_floats: a file the native reader refuses (here a NaN field)
    is read by np.loadtxt; a missing one raises FileNotFoundError, in a
    corpus too."""
    p = tmp_path / "nan.txt"
    p.write_text("1.0,nan\n2.0,3.0\n")
    assert read_csv_native(str(p)) is None
    got = h36m.read_csv_floats(str(p))
    np.testing.assert_array_equal(got, [[1.0, np.nan], [2.0, 3.0]])
    np.testing.assert_array_equal(h36m._read_corpus([str(p)])[str(p)], got)
    with pytest.raises(FileNotFoundError):
        h36m._read_corpus([str(p), str(tmp_path / "missing.txt")])
    with pytest.raises(FileNotFoundError):
        h36m.read_csv_floats(str(tmp_path / "missing.txt"))


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("h36m_native"))
    fixtures.make_h36m_corpus(d, n_frames=340, seed=7)
    return d


@pytest.mark.parametrize("split", [0, 2])
def test_h36m_corpus_bit_identical_to_jax(h36m_dir, jax_reader, split):
    """Both packages' H36MDataset read one corpus through their native
    readers: the expmap frames ('angle') are bit-identical, and the xyz
    frames (forward kinematics in JAX and in torch) within
    tests/test_torch_data.py's 2e-3 mm; the window starts equal."""
    for mode in ("angle", "xyz"):
        ds = h36m.H36MDataset(h36m_dir, 10, 25, 5, split=split, mode=mode)
        jds = jax_h36m.H36MDataset(h36m_dir, 10, 25, 5, split=split,
                                   mode=mode)
        np.testing.assert_array_equal(ds.window_starts, jds.window_starts)
        if mode == "angle":
            np.testing.assert_array_equal(_bits(ds.frames), _bits(jds.frames))
        else:
            np.testing.assert_allclose(ds.frames, jds.frames, atol=2e-3)
