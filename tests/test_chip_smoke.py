"""The CPU-testable parts of chip_smoke.py and of the process helpers it
relies on: the preflight's refusal of a CPU backend, the DP problem
generator and its bucket padding, the stage-log parser, the output
byte-compare, and the compile-cache helper."""

import os

import numpy as np
import pytest

import chip_smoke
from freddie_jax.ops.segdp import bucket_shape, solve_host
from freddie_jax.ops.thresholds import ScaledThresholds
from freddie_jax.utils import procenv


def test_preflight_raises_on_cpu_backend():
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.preflight()


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_generator_lands_in_bucket_and_pads_exactly(wide):
    """Generated problems land in the requested (P, R) bucket above the
    next-smaller edges, carry the promised weight range, and their padded
    batch solves (production jit, CPU) to the host oracle's chains."""
    import jax.numpy as jnp

    from freddie_jax.ops.segdp import _get_jitted

    B, P, R = 6, 32, 256
    problems = chip_smoke.make_problems(np.random.default_rng(5), B, P, R, wide)
    again = chip_smoke.make_problems(np.random.default_rng(5), B, P, R, wide)
    assert all(np.array_equal(a.C, b.C) and np.array_equal(a.W, b.W)
               for a, b in zip(problems, again))
    for pr in problems:
        assert bucket_shape(len(pr.y), pr.C.shape[1]) == (P, R)
        assert len(pr.y) > 16 and pr.C.shape[1] > 128
        assert (pr.W.max() == 16383) if wide else (pr.W.max() <= 127)
    C, y, W, n_cand = chip_smoke.pad_batch(problems, P, R)
    assert C.shape == (B, P, R) and y.shape == (B, P) and W.shape == (B, R)
    for b, pr in enumerate(problems):
        p, r = pr.C.shape
        assert n_cand[b] == p
        assert np.all(y[b, p:] == pr.y[-1]) and np.all(C[b, p:, :r] == pr.C[-1])
        assert np.all(W[b, r:] == 0)
    thr = ScaledThresholds(0.9)
    chains = _get_jitted()(
        jnp.asarray(C), jnp.asarray(y), jnp.asarray(W), jnp.asarray(n_cand),
        read_support=chip_smoke.READ_SUPPORT, lookup=jnp.asarray(thr.lookup),
        scale=thr.scale,
    )
    got = chip_smoke.decode_chains(np.asarray(chains))
    want = [solve_host(pr, thr) for pr in problems]
    assert got == want
    assert any(want)


def test_parse_log_reads_the_pipeline_log(tmp_path, monkeypatch):
    """The pipeline's stage lines and the segment stage's dp summary,
    as the smoke run reads them from the CLI's stdout."""
    from freddie_jax.config import PipelineConfig
    from freddie_jax.stages import segment as seg
    from freddie_jax.stages.pipeline import run_pipeline
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=77, n_genes=4, isoforms_per_gene=3,
                   reads_per_isoform=12, end_jitter=25, indel_rate=0.1,
                   junction_jitter=6, alt_splice=True)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    lines = []
    run_pipeline(bam, [fq], str(tmp_path / "out"), PipelineConfig(),
                 log=lines.append)
    parsed = chip_smoke.parse_log("\n".join(lines))
    assert set(parsed["stages"]) == {"split", "segment", "cluster", "isoforms"}
    assert all(s["engine"] in ("native", "python") and s["seconds"] >= 0
               for s in parsed["stages"].values())
    dp = parsed["dp"]
    assert dp["launches"] > 0
    assert dp["backend"] == "cpu" and dp["devices"] >= 1


def test_compare_outputs_requires_identical_bytes(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for root in (a, b):
        (root / "chr1").mkdir(parents=True)
        (root / "chr1" / "segment_chr1_0.tsv").write_text("x\t1\n")
        (root / "isoforms.gtf").write_text("g\n")
        (root / "chr1" / ".complete").write_text("")
    assert chip_smoke.compare_outputs(str(a), str(b)) == 2
    (b / "chr1" / "segment_chr1_0.tsv").write_text("x\t2\n")
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.compare_outputs(str(a), str(b))
    (b / "chr1" / "segment_chr1_0.tsv").unlink()
    with pytest.raises(AssertionError, match="different output files"):
        chip_smoke.compare_outputs(str(a), str(b))


@pytest.fixture
def cache_dir_config():
    """Restore jax_compilation_cache_dir after a test changes it."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield jax.config
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_left_to_the_environment(cache_dir_config, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = cache_dir_config.jax_compilation_cache_dir
    procenv.use_compile_cache()
    assert cache_dir_config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_the_checkout(cache_dir_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    procenv.use_compile_cache()
    want = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".jax_cache")
    assert cache_dir_config.jax_compilation_cache_dir == want
