"""Host-side pieces of chip_smoke.py and the compile-cache choice it
reports.  The phases themselves need a GPU and run only there."""

import json
import types
from pathlib import Path

import jax
import pytest

import chip_smoke
from libiqo_tpu import api
from libiqo_tpu.core.plan import build_plan
from libiqo_tpu.ops import xla_resize

REPO = Path(__file__).resolve().parents[1]


def _dev(platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_compile_cache_dir_from_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/srv/cache",
           "LIBIQO_TPU_NO_COMPILE_CACHE": "1"}
    assert api.compilation_cache_dir(env) == "/srv/cache"


def test_compile_cache_dir_default_is_fixed_in_checkout():
    d = api.compilation_cache_dir({})
    assert d == str(REPO / ".jax_cache")
    assert api.compilation_cache_dir({}) == d
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_opt_out():
    assert api.compilation_cache_dir({"LIBIQO_TPU_NO_COMPILE_CACHE": "1"}) is None


@pytest.mark.parametrize("count", [1, 4])
def test_last_line(count):
    line = chip_smoke.last_line([_dev()] * count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_require_gpu_rejects_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices())
    assert e.value.code not in (0, None)
    chip_smoke.require_gpu([_dev()])          # one GPU passes


def test_require_gpu_counts_devices():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([_dev()], count=4)
    chip_smoke.require_gpu([_dev()] * 4, count=4)


def test_main_fails_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_form_cases_cover_every_mode():
    cases = chip_smoke.form_cases(chip_smoke.FORMS, luma_wh=(64, 48, 32, 24))
    assert {f for _, _, f, _ in cases if f} == set(chip_smoke.FORMS)
    expected = [e for _, _, f, e in cases if f]
    assert {y for y, _ in expected} == set(chip_smoke.FORMS)
    assert {x for _, x in expected} == set(chip_smoke.FORMS)


@pytest.mark.parametrize("mode", ["f32", "int", "banded"])
def test_forced_form_packs_mode_and_restores_bounds(mode):
    """forced_form lowers the selection bounds only inside its block (bf16
    is never forced on the CPU)."""
    plan = build_plan("lanczos", 97, 61, 31, 23, degree=3)
    before = {k: getattr(xla_resize, k) for k in
              ("_BF16_MAX_COEFS", "_F32_EXACT_COEF_SUM", "_DENSE_LIMIT")}
    t = chip_smoke.forced_tables(plan, mode)
    assert (t.y_mode, t.x_mode) == (mode, mode)
    assert {k: getattr(xla_resize, k) for k in before} == before
    assert xla_resize.build_tables(plan).y_mode == "f32"


def test_phase_forms_small_on_cpu():
    """Phase 2's forced and chosen forms at a small width, bf16 aside."""
    chip_smoke.phase_forms("cpu", ("f32", "int", "banded"),
                           luma_wh=(64, 48, 32, 24))
