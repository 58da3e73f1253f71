"""The compile-cache placement rule (utils/compile_cache.py)."""

import os

import jax
import pytest

from sphsim.utils import compile_cache as cc


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path,
                                              restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path / "outside"))
    for kw in ({}, {"base": str(tmp_path / "b"), "per_host": True}):
        assert cc.setup_persistent_cache(**kw) == str(tmp_path / "outside")
        assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    d = cc.setup_persistent_cache()
    assert d == os.path.join(cc.CHECKOUT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    assert os.path.isfile(os.path.join(cc.CHECKOUT, "chip_smoke.py"))


def test_unset_per_host_adds_fingerprint(monkeypatch, tmp_path,
                                         restore_cache_config):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    d = cc.setup_persistent_cache(str(tmp_path), per_host=True)
    fp = cc.host_fingerprint()
    assert d == str(tmp_path / fp) and len(fp) == 12
    assert cc.host_fingerprint() == fp          # stable on one host
