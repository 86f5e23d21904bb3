"""The port's disk cache (``repro_torch.core.diskcache``), the cases of the
reference's own tests (``tests/test_calibrate.py``): literal round-trips,
corrupted and foreign-schema files as misses, an inert disabled cache,
and a machine fingerprint that follows every field of the machine.  The
port reads its own environment variable, so the packages share no
entries."""
import dataclasses
import json

import pytest

pytest.importorskip("torch")

from repro.core import diskcache as jdiskcache  # noqa: E402
from repro_torch.core import diskcache  # noqa: E402
from repro_torch.core.machine import H100_SXM, GPUMachineModel  # noqa: E402


@pytest.fixture
def cache_dir(tmp_path):
    prev = diskcache.set_cache_dir(tmp_path)
    diskcache.reset_counters()
    yield tmp_path
    diskcache.restore_cache_dir(prev)


def test_own_environment_variable():
    assert diskcache.CACHE_DIR_ENV == "REPRO_TORCH_CACHE_DIR"
    assert diskcache.CACHE_DIR_ENV != jdiskcache.CACHE_DIR_ENV
    assert diskcache.CACHE_SCHEMA == jdiskcache.CACHE_SCHEMA


def test_environment_variable_enables(tmp_path, monkeypatch):
    monkeypatch.setenv(diskcache.CACHE_DIR_ENV, str(tmp_path))
    monkeypatch.delenv(jdiskcache.CACHE_DIR_ENV, raising=False)
    assert diskcache.cache_dir() == tmp_path
    assert jdiskcache.cache_dir() is None


def test_roundtrip_preserves_tuples(cache_dir):
    value = {"block": (128, 256), "ok": True, "t": 1.5}
    diskcache.put("t", ("k", 1), value, machine=H100_SXM)
    diskcache.clear_memo()
    hit = diskcache.get("t", ("k", 1), machine=H100_SXM)
    assert hit == value
    assert isinstance(hit["block"], tuple)
    assert diskcache.COUNTERS["puts"] == 1 and diskcache.COUNTERS["hits"] == 1


def test_other_machine_misses(cache_dir):
    diskcache.put("t", ("k",), {"v": 1}, machine=H100_SXM)
    other = dataclasses.replace(H100_SXM, measured_bw={"copy": 3e12})
    assert diskcache.get("t", ("k",), machine=other) is None
    assert diskcache.get("t", ("k",), machine=H100_SXM) == {"v": 1}


def test_rejects_corrupted_file(cache_dir):
    path = diskcache.put("t", ("k",), {"v": 1}, machine=H100_SXM)
    path.write_text("{not json")
    diskcache.clear_memo()
    rej = diskcache.COUNTERS["rejected"]
    assert diskcache.get("t", ("k",), machine=H100_SXM) is None
    assert diskcache.COUNTERS["rejected"] == rej + 1


def test_rejects_foreign_schema(cache_dir):
    path = diskcache.put("t", ("k",), {"v": 1}, machine=H100_SXM)
    doc = json.loads(path.read_text())
    doc["schema"] = diskcache.CACHE_SCHEMA + 1
    path.write_text(json.dumps(doc))
    diskcache.clear_memo()
    rej = diskcache.COUNTERS["rejected"]
    assert diskcache.get("t", ("k",), machine=H100_SXM) is None
    assert diskcache.COUNTERS["rejected"] == rej + 1


def test_disabled_is_inert():
    prev = diskcache.set_cache_dir(None)
    try:
        assert not diskcache.enabled()
        assert diskcache.put("t", ("k",), {"v": 1}) is None
        assert diskcache.get("t", ("k",)) is None
    finally:
        diskcache.restore_cache_dir(prev)


def test_stable_form_matches_reference():
    for obj in (None, 1, 1.5, "s", (1, [2.0, "x"]), {"b": 1, "a": (2,)}):
        assert diskcache.stable_form(obj) == jdiskcache.stable_form(obj)


_BUMPS = {int: lambda v: v + 1, float: lambda v: v * 1.5 + 0.25, str: lambda v: v + "x",
          bool: lambda v: not v, tuple: lambda v: v + ("x",),
          dict: lambda v: {**v, "copy": 1.0}, type(None): lambda v: 1.0}


@pytest.mark.parametrize("name", [f.name for f in
                                  dataclasses.fields(GPUMachineModel)])
def test_fingerprint_covers_every_field(name):
    fp = diskcache.machine_fingerprint(H100_SXM)
    assert fp == diskcache.machine_fingerprint(dataclasses.replace(H100_SXM))
    value = getattr(H100_SXM, name)
    bumped = dataclasses.replace(H100_SXM, **{name: _BUMPS[type(value)](value)})
    assert diskcache.machine_fingerprint(bumped) != fp


def test_fingerprint_takes_a_machine_only():
    with pytest.raises(TypeError):
        diskcache.machine_fingerprint("NVIDIA H100 80GB HBM3")
