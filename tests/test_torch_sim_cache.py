"""The port's persistent compile cache (``repro_torch.core.sim.compile_cache``),
mirroring ``tests/test_compile_cache.py`` (its three tests of the C
engine's shared object have no counterpart: ``kernels/_build.py`` keys
the CUDA build by source hash):

* key sensitivity: any input that changes the computation misses;
* round trips: tables memory-mapped and equal to built ones, serial
  references exact, bindings, placements and victim plans;
* torn, scribbled, corrupt and version-mismatched artifacts are
  discarded with one warning and rebuilt, never a wrong result;
* ``REPRO_TORCH_SIM_CACHE=0`` bypasses cleanly; the root is the port's
  own (``repro-sim-torch``), apart from the JAX package's;
* a memory-mapped table packs for the card to the same bits as a built
  one, and gives the same results on the plain version and on
  ``csrc/sim.cu`` built for the host.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import topology  # noqa: E402
from repro_torch.core.sim import (Machine, SimParams, bots,  # noqa: E402
                                  compile_cache, get_cache, policy,
                                  reset_cache, runtime)
from repro_torch.core.sim.runtime import (Workload, ensure_table,  # noqa: E402
                                          serial_time)
from repro_torch.core.sim import _engine_py  # noqa: E402
from repro_torch.core.sim.table import TaskTable  # noqa: E402
from repro_torch.kernels import sim as sim_kernel  # noqa: E402
from _torch_sim_cache import port_compile_cache  # noqa: E402,F401

ENV = "REPRO_TORCH_SIM_CACHE"


@pytest.fixture()
def cache_root(tmp_path, monkeypatch):
    """A fresh cache root per test (and a clean handle)."""
    root = tmp_path / "cache"
    monkeypatch.setenv(ENV, str(root))
    reset_cache()
    yield str(root)
    reset_cache()


def _cpu():
    return Machine(topology.sunfire_x4600(), device="cpu")


# ----------------------------------------------------------------------
# location and key sensitivity
# ----------------------------------------------------------------------

def test_root_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_SIM_CACHE", str(tmp_path / "jax"))
    assert compile_cache.cache_root() == str(tmp_path / "repro-sim-torch")
    assert compile_cache.ENV_VAR == ENV
    assert compile_cache.VERIFY_VAR == "REPRO_TORCH_SIM_CACHE_VERIFY"
    reset_cache()


def test_workload_key_sensitivity():
    k = bots.workload_cache_key
    assert k("fft", "medium") == k("fft", "medium")
    assert k("fft", "medium") != k("fft", "large")
    assert k("fft", "medium") != k("sort", "medium")


def test_workload_key_tracks_builder_source(monkeypatch):
    base = bots.workload_cache_key("fft", "medium")
    monkeypatch.setattr(compile_cache, "source_fingerprint",
                        lambda *m: "edited-builder-source")
    assert bots.workload_cache_key("fft", "medium") != base


def _serial_keys(root):
    d = os.path.join(root, "serial")
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_serial_key_sensitivity(cache_root):
    """Changing topology, workload, µ, or λ each mints a new artifact."""
    wl = bots.fft(n=1 << 8, cutoff=4)
    topo = topology.sunfire_x4600()
    n0 = len(_serial_keys(cache_root))
    serial_time(topo, wl, 0, None, SimParams())
    assert len(_serial_keys(cache_root)) == n0 + 1
    serial_time(topology.uma(16), bots.fft(n=1 << 8, cutoff=4), 0, None,
                SimParams())
    assert len(_serial_keys(cache_root)) == n0 + 2
    wl_mu = Workload(wl.name, wl.root, wl.mem_intensity * 2.0,
                     table=ensure_table(wl))
    serial_time(topo, wl_mu, 0, None, SimParams())
    assert len(_serial_keys(cache_root)) == n0 + 3
    serial_time(topo, wl, 0, None, SimParams(hop_lambda=0.7))
    assert len(_serial_keys(cache_root)) == n0 + 4
    serial_time(topo, bots.sort(n=1 << 8, cutoff=4), 0, None, SimParams())
    assert len(_serial_keys(cache_root)) == n0 + 5
    serial_time(topology.sunfire_x4600(), bots.fft(n=1 << 8, cutoff=4),
                0, None, SimParams())
    assert len(_serial_keys(cache_root)) == n0 + 5


# ----------------------------------------------------------------------
# round trips
# ----------------------------------------------------------------------

def test_make_round_trip_is_mmap_backed_and_identical(cache_root):
    built = bots.make("fft", "medium")
    restored = bots.make("fft", "medium")
    assert built is not restored and restored.root is None
    t0, t1 = ensure_table(built), ensure_table(restored)
    assert isinstance(t1.work_pre, np.memmap)
    assert not t1.work_pre.flags["WRITEABLE"]
    assert t1.fingerprint() == t0.fingerprint()
    for name in TaskTable.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(t0, name), getattr(t1, name))
    assert get_cache().hit_count("tables") == 1


def test_serial_value_round_trips_exactly(cache_root):
    topo = topology.sunfire_x4600()
    fresh = serial_time(topo, bots.fft(n=1 << 10, cutoff=8), 0, None,
                        SimParams())
    replayed = serial_time(topo, bots.fft(n=1 << 10, cutoff=8), 0, None,
                           SimParams())
    assert replayed == fresh
    assert get_cache().hit_count("serial") == 1


def test_context_and_victim_plan_round_trip(cache_root):
    kw = dict(seed=0, threads=16, binding="paper", placement="spill:2")
    r1 = _cpu().run(bots.fft(n=1 << 10, cutoff=8), "dfwsrpt", **kw)
    reset_cache()
    r2 = _cpu().run(bots.fft(n=1 << 10, cutoff=8), "dfwsrpt", **kw)
    assert r1 == r2
    stats = get_cache().stats()
    assert stats["hits"].get("contexts") and stats["hits"].get("plans")
    assert stats["corrupt"] == {}
    assert _cpu().compile_cache is get_cache()


def test_mmap_tables_same_bits_on_both_engines(cache_root, monkeypatch,
                                               tmp_path):
    """A memory-mapped table packs for the card to the same bits as a
    built one, and runs to the same results on the plain version and on
    the kernel's loop built for the host."""
    bots.make("fft", "medium")
    restored = bots.make("fft", "medium")
    assert isinstance(ensure_table(restored).work_pre, np.memmap)
    monkeypatch.setenv(ENV, "0")
    reset_cache()
    fresh = bots.make("fft", "medium")
    assert not isinstance(ensure_table(fresh).work_pre, np.memmap)
    m = _cpu()
    kw = dict(seed=3, threads=16, binding="paper", placement="spill:2")
    assert m.run(fresh, "dfwsrpt", **kw) == m.run(restored, "dfwsrpt", **kw)

    def ctx(wl):
        return runtime._prepare_ctx(
            m.context(16, binding="paper", placement="spill:2"), wl,
            policy.get_spec("dfwsrpt"), 3)
    a, b = sim_kernel.pack([ctx(fresh)]), sim_kernel.pack([ctx(restored)])
    for name in ("desc", "dbuf", "ibuf", "aggi", "aggd"):
        assert a[name].dtype == b[name].dtype
        assert a[name].tobytes() == b[name].tobytes(), name
    try:
        lib = sim_kernel.build_host(tmp_path)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        pytest.skip("no C++ compiler to build the kernel source")
    got = sim_kernel.run_batch_host([ctx(fresh), ctx(restored)], lib)
    assert got[0] == got[1] == _engine_py.run(ctx(restored))


# ----------------------------------------------------------------------
# corruption tolerance
# ----------------------------------------------------------------------

def test_torn_table_artifact_rebuilds_with_warning(cache_root):
    bots.make("fft", "medium")
    expected = ensure_table(bots.make("fft", "medium"))
    blobs = glob.glob(os.path.join(cache_root, "tables", "*", "*.npy"))
    assert blobs
    with open(blobs[0], "r+b") as f:
        f.truncate(os.path.getsize(blobs[0]) // 2)
    reset_cache()
    with pytest.warns(RuntimeWarning, match="compile cache"):
        rebuilt = bots.make("fft", "medium")
    assert ensure_table(rebuilt).fingerprint() == expected.fingerprint()
    assert get_cache().stats()["corrupt"].get("tables") == 1
    assert ensure_table(bots.make("fft", "medium")).fingerprint() \
        == expected.fingerprint()
    assert get_cache().stats()["corrupt"].get("tables") == 1


def test_scribbled_manifest_rebuilds(cache_root):
    bots.make("fft", "medium")
    manifests = glob.glob(os.path.join(cache_root, "tables", "*",
                                       "manifest.json"))
    assert manifests
    with open(manifests[0], "w") as f:
        f.write('{"format": "repro-sim-compile-cache", "version": 1, '
                '"payload": {"arrays": {}, "meta": {}}, '
                '"checksum": "0000"}')
    reset_cache()
    with pytest.warns(RuntimeWarning, match="checksum"):
        wl = bots.make("fft", "medium")
    assert ensure_table(wl).n > 0


def test_corrupt_serial_artifact_rebuilds(cache_root):
    topo = topology.sunfire_x4600()
    fresh = serial_time(topo, bots.fft(n=1 << 10, cutoff=8), 0, None,
                        SimParams())
    files = glob.glob(os.path.join(cache_root, "serial", "*.json"))
    assert files
    with open(files[0], "w") as f:
        f.write("{ torn json")
    reset_cache()
    with pytest.warns(RuntimeWarning, match="compile cache"):
        replayed = serial_time(topo, bots.fft(n=1 << 10, cutoff=8), 0,
                               None, SimParams())
    assert replayed == fresh


def test_version_mismatch_is_discarded(cache_root):
    cache = get_cache()
    cache.put_json("serial", "k1", {"serial": 1.5})
    path = cache._json_path("serial", "k1")
    with open(path) as f:
        doc = json.load(f)
    doc["version"] = 999
    with open(path, "w") as f:
        json.dump(doc, f)
    with pytest.warns(RuntimeWarning, match="version mismatch"):
        assert cache.get_serial("k1") is None
    cache.put_serial("k1", 2.5)
    assert cache.get_serial("k1") == 2.5


def test_put_get_arrays_verifies_structure(cache_root):
    cache = get_cache()
    arrays = dict(a=np.arange(5, dtype=np.int64), b=np.linspace(0, 1, 5))
    cache.put_arrays("tables", "k", arrays, {"note": "x"})
    got, meta = cache.get_arrays("tables", "k")
    assert meta == {"note": "x"}
    np.testing.assert_array_equal(got["a"], arrays["a"])
    np.testing.assert_array_equal(got["b"], arrays["b"])
    path = os.path.join(cache_root, "tables", "k", "a.npy")
    blob = np.load(path)
    blob[0] = 999
    with open(path, "wb") as f:
        np.save(f, blob)
    with pytest.warns(RuntimeWarning, match="data checksum"):
        assert cache.get_arrays("tables", "k") is None


def test_repeated_puts_are_safe(cache_root):
    cache = get_cache()
    cache.put_json("serial", "k", {"serial": 1.0})
    cache.put_json("serial", "k", {"serial": 1.0})
    assert cache.get_serial("k") == 1.0
    a1 = dict(x=np.arange(3, dtype=np.int64))
    cache.put_arrays("tables", "k2", a1, {})
    cache.put_arrays("tables", "k2", dict(x=np.arange(3, dtype=np.int64)),
                     {})
    got, _ = cache.get_arrays("tables", "k2")
    np.testing.assert_array_equal(got["x"], a1["x"])


# ----------------------------------------------------------------------
# the disable switch
# ----------------------------------------------------------------------

def test_cache_disabled_bypasses_cleanly(monkeypatch):
    monkeypatch.setenv(ENV, "0")
    reset_cache()
    assert get_cache() is None and compile_cache.cache_root() is None
    wl = bots.make("fft", "medium")
    assert not isinstance(ensure_table(wl).work_pre, np.memmap)
    r = _cpu().run(wl, "wf", seed=0, threads=8, binding="paper")
    assert r.makespan > 0
    reset_cache()


def test_env_change_re_resolves_handle(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, str(tmp_path / "a"))
    c1 = get_cache()
    monkeypatch.setenv(ENV, str(tmp_path / "b"))
    c2 = get_cache()
    assert c1 is not c2 and c1.root != c2.root
    monkeypatch.setenv(ENV, "0")
    assert get_cache() is None
    reset_cache()
