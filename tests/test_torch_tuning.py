"""The block tuner of the PyTorch port (`paddle_tpu_torch/kernels/
tuning.py`), held to the behaviours of tests/test_kernel_tuning.py: the
lookup order env pin > disk cache > measurement (opt-in, on a card only) >
the call site's fallback > defaults, shape buckets equal to the JAX
tuner's, a measurement crash tolerated, and every pick in the registry.
B8's tile through the tuner with no env and no cache is `tile()`'s rule.
"""

import json

import pytest
import torch

from paddle_tpu.kernels import tuning as jtuning
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import tuning
from paddle_tpu_torch.observability import (MetricsRegistry,
                                            set_global_registry,
                                            write_run_telemetry)

DEFAULTS = {"block_q": 512, "block_k": 1024}
SHAPE = {"seq_q": 1024, "seq_k": 1024, "head_dim": 128}
# the call site's rule, as B8 passes `tile()`'s pick
FALLBACK = {"block_q": 512, "block_k": 512}
CARD = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets an empty on-disk cache, no env overrides and a fresh
    global registry."""
    monkeypatch.setenv("PADDLE_TUNING_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.delenv("PADDLE_TUNE_BLOCKS", raising=False)
    monkeypatch.delenv("PADDLE_KERNEL_AUTOTUNE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(qm._sm_count, CARD, 132)   # an H100's SMs
    reg = MetricsRegistry()
    prev = set_global_registry(reg)
    tuning.clear_memory_cache()
    yield reg
    tuning.clear_memory_cache()
    set_global_registry(prev)


def _get(shape=SHAPE, **kw):
    kw.setdefault("fallback", FALLBACK)
    return tuning.get_blocks("flash_fwd", shape, torch.bfloat16, DEFAULTS,
                             **kw)


class TestResolution:
    def test_cpu_fallback(self):
        out = _get()
        assert set(out) == set(DEFAULTS)
        assert out == FALLBACK

    def test_unknown_kernel_falls_back_to_defaults(self):
        out = tuning.get_blocks("no_such_kernel", {"seq": 64}, torch.float32,
                                {"block": 128})
        assert out == {"block": 128}

    def test_cold_measure_then_cache_hit(self, monkeypatch):
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")
        calls = []

        def measure(blocks):
            calls.append(dict(blocks))
            return 1.0 if blocks["block_k"] == 512 else 2.0

        cands = [{"block_q": 512, "block_k": 512},
                 {"block_q": 512, "block_k": 1024}]
        out = _get(measure=measure, candidates=cands, device=CARD)
        assert out == {"block_q": 512, "block_k": 512}
        assert len(calls) == 2
        tuning.clear_memory_cache()   # a new process
        assert _get(measure=measure, candidates=cands, device=CARD) == out
        assert len(calls) == 2        # a cache hit: no measurement
        on_disk = json.loads(open(tuning.cache_path()).read())
        assert any(k.startswith("flash_fwd|") for k in on_disk)

    def test_env_override_wins_over_cache(self, monkeypatch):
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")
        _get(measure=lambda b: 1.0,
             candidates=[{"block_q": 256, "block_k": 256}], device=CARD)
        monkeypatch.setenv("PADDLE_TUNE_BLOCKS", json.dumps(
            {"flash_fwd": {"block_q": 1024}}))
        out = _get(device=CARD)
        assert out["block_q"] == 1024   # env pin
        assert out["block_k"] == 256    # the rest still from the cache

    def test_env_override_ignores_unknown_keys_and_bad_json(self,
                                                            monkeypatch):
        monkeypatch.setenv("PADDLE_TUNE_BLOCKS", json.dumps(
            {"flash_fwd": {"not_a_param": 7, "block_k": 256}}))
        out = _get()
        assert out["block_k"] == 256 and "not_a_param" not in out
        monkeypatch.setenv("PADDLE_TUNE_BLOCKS", "{not json")
        with pytest.warns(UserWarning):
            out = _get()
        assert out == FALLBACK

    def test_no_measurement_without_optin_or_card(self, monkeypatch):
        calls = []
        cands = [{"block_q": 256, "block_k": 256}]
        _get(measure=lambda b: calls.append(b) or 1.0, candidates=cands,
             device=CARD)
        assert not calls
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")   # env, no card
        for device in (None, torch.device("cpu")):
            _get(measure=lambda b: calls.append(b) or 1.0, candidates=cands,
                 device=device)
        assert not calls

    def test_measure_crash_tolerance(self, monkeypatch):
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")

        def flaky(blocks):
            if blocks["block_k"] == 1024:
                raise RuntimeError("does not launch")
            return 3.0

        out = _get(measure=flaky, device=CARD,
                   candidates=[{"block_q": 512, "block_k": 1024},
                               {"block_q": 256, "block_k": 256}])
        assert out == {"block_q": 256, "block_k": 256}
        tuning.clear_memory_cache()
        dead = tuning.measure_and_cache(
            "flash_bwd", SHAPE, "bfloat16",
            [{"block_q": 512, "block_k": 1024}],
            lambda b: (_ for _ in ()).throw(RuntimeError("boom")),
            fallback=FALLBACK, device=CARD)
        assert dead == FALLBACK


class TestBucketing:
    def test_bucket(self):
        assert tuning.bucket(1024) == 1024
        assert tuning.bucket(1536) == 1024
        assert tuning.bucket(2047) == 1024
        assert tuning.bucket(2048) == 2048
        assert tuning.bucket(0) == 0

    def test_bucket_equals_the_jax_tuners(self):
        assert [tuning.bucket(n) for n in range(-3, 5001)] == \
            [jtuning.bucket(n) for n in range(-3, 5001)]

    def test_bucketed_shapes_share_cache_entry(self, monkeypatch):
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")
        calls = []
        for sq in (1024, 1536):
            _get(dict(SHAPE, seq_q=sq, seq_k=sq), device=CARD,
                 measure=lambda b: calls.append(b) or 1.0,
                 candidates=[{"block_q": 256, "block_k": 256}])
        assert len(calls) == 1

    def test_cache_key_names_the_card(self, monkeypatch):
        """The cache is keyed by torch.cuda.get_device_name: another card
        does not read this one's picks."""
        monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        name = {"now": "NVIDIA H100 80GB HBM3"}
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None: name["now"])
        calls = []
        for card in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"):
            name["now"] = card
            _get(device=CARD, measure=lambda b: calls.append(b) or 1.0,
                 candidates=[{"block_q": 256, "block_k": 256}])
        assert len(calls) == 2
        keys = json.loads(open(tuning.cache_path()).read())
        assert sorted(k.rsplit("|", 1)[1] for k in keys) == [
            "NVIDIA_H100_80GB_HBM3", "NVIDIA_H100_PCIe"]


class TestTelemetry:
    def test_blocks_land_in_telemetry_artifact(self, tmp_path,
                                               _isolated_cache):
        _get()
        path = tmp_path / "telemetry.json"
        write_run_telemetry(str(path), record={"metric": "t", "value": 1},
                            registry=_isolated_cache)
        art = json.loads(path.read_text())
        by_label = {k: v["value"] for k, v in
                    art["metrics"]["gauges"]["kernel_block"].items()}
        assert any("kernel=flash_fwd" in k and "param=block_q" in k
                   for k in by_label), by_label
        counters = art["metrics"]["counters"]["kernel_tuning_lookups"]
        assert any("kernel=flash_fwd" in k for k in counters)

    def test_lookup_source_counter(self, _isolated_cache):
        tuning.get_blocks("decode_attention", {"seq": 2048}, torch.bfloat16,
                          {"block_k": 512})
        keys = _isolated_cache.snapshot()["counters"]["kernel_tuning_lookups"]
        assert any("kernel=decode_attention" in k and "source=fallback" in k
                   for k in keys)


@pytest.mark.parametrize("m", [17, 100, 512, 1500, 2048, 8192])
@pytest.mark.parametrize("n", [4096, 11008, 32000])
def test_b8_tile_without_env_or_cache_is_the_rule(m, n, _isolated_cache):
    """B8's tile through the tuner, with no env pin and an empty cache, is
    what `tile()`'s wave-cost rule picks; the pick goes to the registry."""
    got = qm.tuned_tile(m, 4096, n, torch.bfloat16, CARD)
    assert got == qm.tile(m, n, 132)
    gauges = _isolated_cache.snapshot()["gauges"]["kernel_block"]
    assert gauges["kernel=b8_tile,param=tile_m"]["value"] == got[0]


def test_b8_tile_env_pin_and_cache(monkeypatch, _isolated_cache):
    """PADDLE_TUNE_BLOCKS pins B8's tile; a pin off its TILES raises; a
    cached pick is read back."""
    monkeypatch.setenv("PADDLE_TUNE_BLOCKS", json.dumps(
        {"b8_tile": {"tile_m": 128, "tile_n": 128}}))
    assert qm.tuned_tile(2048, 4096, 11008, torch.bfloat16, CARD) == (128, 128)
    monkeypatch.setenv("PADDLE_TUNE_BLOCKS", json.dumps(
        {"b8_tile": {"tile_m": 64}}))
    with pytest.raises(ValueError, match="TILES"):
        qm.tuned_tile(2048, 4096, 11008, torch.bfloat16, CARD)
    monkeypatch.delenv("PADDLE_TUNE_BLOCKS")
    monkeypatch.setenv("PADDLE_KERNEL_AUTOTUNE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    times = {(256, 128): 3.0, (128, 256): 1.0, (128, 128): 2.0}
    got = qm.tuned_tile(8192, 4096, 11008, torch.bfloat16, CARD,
                        measure=lambda b: times[(b["tile_m"], b["tile_n"])])
    assert got == (128, 256)
    tuning.clear_memory_cache()
    assert qm.tuned_tile(8192, 4096, 11008, torch.bfloat16, CARD) == (128, 256)
    lookups = _isolated_cache.snapshot()["counters"]["kernel_tuning_lookups"]
    assert lookups["kernel=b8_tile,source=measured"] == 1
    assert lookups["kernel=b8_tile,source=cache"] == 1
