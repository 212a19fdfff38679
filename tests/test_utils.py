"""Progress / profiling utilities."""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from visfd_jax.utils import Report, stage, stage_timings


def test_report_and_stage():
    buf = io.StringIO()
    rep = Report(buf)
    with stage("blur", rep):
        rep.line("processing plane 1 / 4")
    out = buf.getvalue()
    assert "---- blur ----" in out
    assert "processing plane 1 / 4" in out
    assert "blur" in rep.timings and rep.timings["blur"] >= 0.0


def test_report_none_is_silent():
    rep = Report(None)
    with stage("x", rep):
        rep.line("hidden")
    assert "x" in rep.timings


def test_stage_timings():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(32, 32)))
    t = stage_timings([("square", lambda: x * x)], warmup=1, iters=2)
    assert t["square"] > 0.0


def test_report_accepted_by_segmentation():
    from visfd_jax.segment.connect import label_connected
    rng = np.random.default_rng(0)
    sal = rng.random((6, 6, 6)).astype(np.float32)
    buf = io.StringIO()
    res = label_connected(sal, threshold_saliency=0.5, report=Report(buf))
    assert "Number of clusters found:" in buf.getvalue()
    assert res.num_clusters >= 1


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is JAX's own and nothing is
    overridden; otherwise the cache goes to the fixed <repo>/.jax_cache
    (git-ignored), never a temporary or per-process name."""
    import pathlib

    import jax

    from visfd_jax.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "unchanged")
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "unchanged"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            repo = pathlib.Path(__file__).resolve().parents[1]
            want = str(repo / ".jax_cache")
            assert cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
            assert ".jax_cache/" in (repo / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
