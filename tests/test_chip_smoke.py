"""CPU tests of what chip_smoke.py and bench.py do — the no-GPU exit, the
compile-cache rule, every smoke phase at tiny size — plus the entry
points of __graft_entry__.py.  The tests marked ``gpu`` need the card
and skip elsewhere."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_mod():
    return _load("chip_smoke")


@pytest.fixture(scope="module")
def tiny(smoke_mod):
    return smoke_mod.Smoke("cpu test", n_b=40_000, n_check=20_000,
                           n_key8b=30_000, n_m2m=5_000)


def test_chip_smoke_exits_without_gpu(smoke_mod, capsys):
    assert smoke_mod.main([]) != 0
    cap = capsys.readouterr()
    assert "no GPU" in cap.err
    assert '"ok"' not in cap.out  # prints no result


def test_chip_smoke_four_exits_without_gpu(smoke_mod, capsys):
    assert smoke_mod.main(["--four"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_bench_exits_without_gpu(capsys):
    bench = _load("bench")
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert "no GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_bench_run_join_tiny():
    """bench.py's timed step: the m-way program, exact on workload B."""
    bench = _load("bench")
    rk, sk = bench._gen_workload(10_000)
    assert bench.run_join(rk, sk, 10_000) == 10_000


@pytest.mark.parametrize("phase", ["algorithms", "phase_split",
                                   "skew_and_duplicates", "key8b",
                                   "materialize", "four"])
def test_chip_smoke_phase_tiny(tiny, phase, capsys):
    """Each smoke phase runs and checks itself at a tiny size."""
    getattr(tiny, phase)()
    out = capsys.readouterr().out
    assert "[phase]" in out and "[cpu test]" in out or phase == "four"


def test_chip_smoke_card_info_without_nvidia_smi(smoke_mod, monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert "unavailable" in smoke_mod.card_info()


def test_chip_smoke_lowering_reports_sorts(smoke_mod):
    import jax
    import jax.numpy as jnp

    text = smoke_mod.lowering(jax.jit(jnp.sort), jnp.arange(8))
    assert "custom calls" in text and "XLA sort ops" in text


def test_chip_smoke_numpy_join_rows(smoke_mod):
    rk = np.array([1, 1, 2], np.int32)
    sk = np.array([1, 2, 3], np.int32)
    sp = np.array([10, 20, 30], np.int32)
    ek, ep = smoke_mod.numpy_join_rows(rk, sk, sp)
    assert ek.tolist() == [1, 1, 2] and ep.tolist() == [10, 10, 20]


def test_cache_dir_from_env(monkeypatch, tmp_path):
    from avx_sort_merge_joins_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_in_checkout(monkeypatch):
    from avx_sort_merge_joins_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_cache_not_configured_on_cpu(monkeypatch):
    """CPU programs are not cached: the CPU path sets no directory."""
    import jax

    from avx_sort_merge_joins_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_graft_entry_forward():
    import jax

    graft = _load("__graft_entry__")
    forward, (rk, sk) = graft.entry()
    assert int(jax.jit(forward)(rk, sk)) == rk.shape[0]


def test_graft_dryrun_multichip(capsys):
    graft = _load("__graft_entry__")
    graft.dryrun_multichip(4)
    assert "CPU rehearsal" in capsys.readouterr().out


@pytest.mark.gpu
def test_gpu_sorts_lower_to_library_sort(gpu, smoke_mod):
    """On the card every sort shape of the engine is the library radix
    sort (a custom call), never XLA's own sort op."""
    import jax
    import jax.numpy as jnp

    from avx_sort_merge_joins_tpu.ops import sort

    k = jnp.arange(1 << 20, dtype=jnp.int32)[::-1]
    for fn, args in ((sort.sort_keys, (k,)), (sort.sort_pairs, (k, k))):
        assert "XLA sort ops: 0" in smoke_mod.lowering(jax.jit(fn), *args)


@pytest.mark.gpu
def test_gpu_smoke_phases(gpu, tiny):
    """The single-card smoke phases at a tiny size on the card."""
    for phase in ("algorithms", "phase_split", "skew_and_duplicates",
                  "key8b", "materialize"):
        getattr(tiny, phase)()
