"""Many-loci end-to-end stress: 40 noisy genes / 9600 reads through the
full pipeline. Exercises the simulator's genome auto-growth (gene layout
past the initial contig length), per-contig multi-tint routing, and the
solver under a wide spread of instance sizes in one run."""

from freddie_jax.config import PipelineConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate


def test_forty_gene_pipeline(tmp_path):
    sim = simulate(seed=11, n_genes=40, isoforms_per_gene=3, reads_per_isoform=80,
                   end_jitter=20, indel_rate=0.05, junction_jitter=4)
    assert sim.contig_len > 2_000_000  # layout forced genome growth
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(tmp_path / "out")
    stats = run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    assert stats["split"]["result"] == {"chr1": 40}
    gtf = open(f"{out}/isoforms.gtf").read().splitlines()
    n_tr = sum(1 for l in gtf if l.split("\t")[2] == "transcript")
    # 120 true isoforms; jitter noise may add subclusters but every gene
    # must be represented and the count must stay in a sane band
    assert 120 <= n_tr <= 160, n_tr
    # structure recovery: most true isoforms appear exactly
    want = {tuple(tr.exons) for tr in sim.transcripts}
    got, cur = set(), []
    for l in gtf:
        f = l.split("\t")
        if f[2] == "transcript":
            if cur:
                got.add(tuple(cur))
            cur = []
        else:
            cur.append((int(f[3]), int(f[4])))
    if cur:
        got.add(tuple(cur))
    # exact coordinates are not expected under junction/end jitter: require
    # a strong majority recovered within the simulated wobble (internal
    # boundaries within ~2x junction_jitter, read ends within end_jitter
    # plus the boundary-correction window)
    def matches(t, g, internal_tol=10, end_tol=40):
        if len(t) != len(g):
            return False
        tb = [b for ex in t for b in ex]
        gb = [b for ex in g for b in ex]
        for i, (a, b) in enumerate(zip(tb, gb)):
            tol = end_tol if i in (0, len(tb) - 1) else internal_tol
            if abs(a - b) > tol:
                return False
        return True

    recovered = sum(1 for t in want if any(matches(t, g) for g in got))
    assert recovered >= 0.85 * len(want), (recovered, len(want))
