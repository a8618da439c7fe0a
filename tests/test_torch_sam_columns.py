"""The SAM path's plain versions (kslam_tpu_torch/ops/sam_cuda.py) and
columnar writer (kslam_tpu_torch/io/sam_columns.py) against the JAX
package, on the CPU:

  * sam_cigar_plain, per alignment, bit for bit equal to
    kslam_tpu.golden.ssw.slam_overlap_align(..., report_cigar=True):
    score, begins and ends, cigar (None for the filter and the abort);
    the banded DP's abort against the golden banded_cigar;
  * sam_diff_plain and prob = 10 ** log10 probability equal to
    kslam_tpu.io.sam.get_cigar_and_md (prob bit for bit);
  * io/sam_columns.write_sam writing the bytes of the copied
    pipeline/run._fill_cigars + io/sam.write_sam_pairs.

Inputs come from numpy Generators (kslam_tpu_torch/eval/sam_cases.py).
The CUDA kernels are held to these plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import copy
import io

import numpy as np
import pytest
import torch

from kslam_tpu.config import SWParams as JSWParams
from kslam_tpu.golden import ssw as jssw
from kslam_tpu.io import sam as jsam
from kslam_tpu.pipeline.pairing import AlignedOverlap as JOverlap
from kslam_tpu_torch.config import PipelineConfig
from kslam_tpu_torch.db.genbank import Gene, GenbankEntry, GenbankIndex
from kslam_tpu_torch.eval import sam_cases
from kslam_tpu_torch.io import sam as sam_io, sam_columns
from kslam_tpu_torch.io.fastq import ReadBatch
from kslam_tpu_torch.ops import encode, sam_cuda
from kslam_tpu_torch.pipeline import pairing, run

torch.set_num_threads(1)

SW = JSWParams()
PARAMS = (SW.match, SW.mismatch, SW.gap_open, SW.gap_extend)

# name -> (alignments() keyword arguments, score_filter)
CIGAR_CASES = {
    "forward": (dict(indel_share=0.0, end_share=0.0, odd_share=0.0), 0),
    "rc": (dict(indel_share=0.3, end_share=0.0, odd_share=0.0), 0),
    "indels": (dict(indel_share=1.0, indel=0.03, shift_share=0.5,
                    end_share=0.0, odd_share=0.0), 0),
    "entry_end": (dict(indel_share=0.2, end_share=1.0, odd_share=0.0), 0),
    "score_filter": (dict(sub=0.08, indel_share=0.3), 260),
    "reads_with_n": (dict(indel_share=0.2, odd_share=1.0), 0),
}


def _columns(seed: int, n: int, **kw):
    rng = np.random.default_rng(seed)
    ents = sam_cases.entries(rng, n_entries=3, length=1200)
    return sam_cases.alignments(rng, ents, n, **kw), rng


def _plain_cigar(c, score_filter=0):
    return sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, "cpu"), PARAMS,
                              score_filter,
                              sam_cuda.native_max_ops(c["lengths"]))


@pytest.mark.parametrize("case", list(CIGAR_CASES))
def test_sam_cigar_plain_matches_golden(case, monkeypatch):
    kw, score_filter = CIGAR_CASES[case]
    c, _ = _columns(sum(map(ord, case)), 24, **kw)
    if case == "forward":
        c["rc"][:] = 0
    elif case == "rc":
        c["rc"][:] = 1
    bands = []
    orig = sam_cuda.banded_cigar_plain

    def record(*args, **kwargs):
        out = orig(*args, **kwargs)
        bands.append((args[5], out[2]))
        return out
    monkeypatch.setattr(sam_cuda, "banded_cigar_plain", record)
    got = _plain_cigar(c, score_filter)
    codes = encode.sw_codes_np(c["bases"])
    for k in range(len(c["read_id"])):
        e = c["entry_id"][k]
        al = jssw.slam_overlap_align(
            encode.sw_codes_np(c["reads"][k, :c["lengths"][k]]),
            codes[c["offsets"][e]:c["offsets"][e + 1]], int(c["rel_pos"][k]),
            bool(c["rc"][k]), SW, report_cigar=True,
            score_filter=score_filter)
        n_runs = int(got["cigar_len"][k])
        cigar = None if n_runs < 0 else [
            (int(v) >> 4, "MID"[int(v) & 15])
            for v in got["cigar_buf"][k, :n_runs]]
        assert (int(got["score"][k]), int(got["ref_begin"][k]),
                int(got["ref_end"][k]), int(got["query_begin"][k]),
                int(got["query_end"][k]), cigar) == \
            (al.sw_score, al.ref_begin, al.ref_end, al.query_begin,
             al.query_end, al.cigar), (case, k)
    doublings = max((int(torch.log2(w / b).max()) for b, w in bands
                     if len(b)), default=0)
    if case == "indels":
        assert doublings >= 2
    if case == "score_filter":
        assert (got["cigar_len"] == sam_cuda.FILTERED).any() and \
            (got["cigar_len"] >= 0).any()
    if case == "entry_end":
        assert (c["rel_pos"] < 0).any() and (got["query_begin"] > 0).any()


@pytest.mark.parametrize("case", ["width_limit", "unreachable_score"])
def test_banded_abort(case):
    """The overflow abort (ssw.c:631-642): a band whose direction slab
    would pass 2^31 bytes aborts at once, as the golden banded_cigar
    does; a score the DP cannot reach aborts once the band covers every
    cell, where the golden model gives the same cigar at that band and
    at twice it (so its doubling on to the width limit changes nothing
    but the allocation)."""
    rng = np.random.default_rng(7)
    read = rng.integers(0, 4, 40)
    ref = read.copy()
    ref[[5, 17, 30]] = (ref[[5, 17, 30]] + 1) % 4
    score = jssw.sw_forward_ends(read, ref, SW)[0]
    t = torch.as_tensor(np.stack([read]))
    f = torch.as_tensor(np.stack([ref]))
    n = torch.tensor([40])
    if case == "width_limit":
        band = (1 << 31) // (3 * 40)
        assert jssw.banded_cigar(read, ref, score, SW, band) is None
        _, n_runs, _ = sam_cuda.banded_cigar_plain(
            t, n, f, n, torch.tensor([score]), torch.tensor([band]), PARAMS,
            200)
        assert int(n_runs[0]) == sam_cuda.ABORTED
        return
    cover = 39
    want = jssw.banded_cigar(read, ref, score, SW, cover)
    assert want == jssw.banded_cigar(read, ref, score, SW, 2 * cover)
    for band in (cover, 2 * cover):
        runs, n_runs, _ = sam_cuda.banded_cigar_plain(
            t, n, f, n, torch.tensor([score]), torch.tensor([band]), PARAMS,
            200)
        got = [(int(v) >> 4, "MID"[int(v) & 15])
               for v in runs[0, :int(n_runs[0])].flip(0)]
        assert got == want
    _, n_runs, w = sam_cuda.banded_cigar_plain(
        t, n, f, n, torch.tensor([score + 1]), torch.tensor([1]), PARAMS, 200)
    assert int(n_runs[0]) == sam_cuda.ABORTED and int(w[0]) >= cover


# --- sam_diff_plain against get_cigar_and_md ----------------------------

DIFF_CASES = ["walk", "iupac_ref", "lowercase_reads", "past_entry_end",
              "cigar_none_and_empty", "qualities_outside", "deletions",
              "caret_in_reference"]


def _diff_case(case: str, n: int = 60):
    """(reads, qualities, entries as bytes; overlaps as JOverlap)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    letters = b"ACGT"
    if case == "iupac_ref":
        letters = b"ACGTRYKMSWNacgt"
    if case == "caret_in_reference":
        letters = b"ACGT^^5"
    ents = [bytes(rng.choice(np.frombuffer(letters, np.uint8),
                             int(rng.integers(200, 400))))
            for _ in range(3)]
    reads, quals, ovs = [], [], []
    for k in range(n):
        e = int(rng.integers(len(ents)))
        rb = int(rng.integers(0, len(ents[e]) - 20))
        if case == "past_entry_end":
            rb = len(ents[e]) - int(rng.integers(1, 60))
        length = int(rng.integers(20, 150))
        seg = np.frombuffer(ents[e][rb:rb + length].upper()
                            .replace(b"^", b"A").replace(b"5", b"C"),
                            np.uint8).copy()
        seg = seg[np.isin(seg, np.frombuffer(b"ACGTN", np.uint8))]
        if len(seg) == 0:
            seg = np.frombuffer(b"ACGT", np.uint8).copy()
        hit = rng.random(len(seg)) < 0.05
        seg[hit] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(hit.sum()))]
        read = seg.tobytes()
        if case == "lowercase_reads":
            read = read.lower() if k % 2 else read[:5].lower() + read[5:]
        reads.append(read)
        if case == "qualities_outside":
            quals.append(bytes(rng.integers(0, 256, len(read),
                                            dtype=np.uint8)))
        else:
            quals.append(bytes(rng.integers(35, 75, len(read),
                                            dtype=np.uint8)))
        runs = []
        left = len(read)
        while left > 0 and len(runs) < 6:
            op = "M" if case not in ("deletions", "caret_in_reference") \
                else "MDMIM"[len(runs) % 5]
            if rng.random() < 0.2:
                op = "MID"[int(rng.integers(3))]
            step = int(rng.integers(0 if op == "M" else 1, left + 1))
            runs.append((step, op))
            left -= step if op != "D" else 0
        cigar = runs
        if case == "cigar_none_and_empty":
            cigar = (None, [], runs)[k % 3]
        qb = int(rng.integers(0, 4))
        qe = len(read) - 1 - int(rng.integers(-1, 4))
        ovs.append(JOverlap(k, e, 0, bool(k % 2), 0, rb, 0, qb, qe, cigar))
    return reads, quals, ents, ovs


@pytest.mark.parametrize("case", DIFF_CASES)
def test_sam_diff_plain_matches_walk(case):
    reads, quals, ents, ovs = _diff_case(case)
    n = len(ovs)
    stride = max(len(r) for r in reads)
    r_arr = np.zeros((n, stride), np.uint8)
    q_arr = np.zeros((n, stride), np.uint8)
    for k in range(n):
        r_arr[k, :len(reads[k])] = np.frombuffer(reads[k], np.uint8)
        q_arr[k, :len(quals[k])] = np.frombuffer(quals[k], np.uint8)
    width = max([len(o.cigar) for o in ovs if o.cigar] + [1])
    buf = np.zeros((n, width), np.int32)
    n_runs = np.zeros(n, np.int32)
    for k, o in enumerate(ovs):
        if o.cigar is None:
            n_runs[k] = sam_cuda.NO_CIGAR
            continue
        # [] stands for the abort (-1) or the filter (-2) as well
        n_runs[k] = len(o.cigar) if o.cigar else (-1, -2)[k % 2]
        for j, (length, op) in enumerate(o.cigar):
            buf[k, j] = (length << 4) | "MID".index(op)
    offs = np.cumsum([0] + [len(e) for e in ents]).astype(np.int64)
    dwin, dlen, _ = sam_cuda.diff_windows(
        np.frombuffer(b"".join(ents), np.uint8), offs,
        np.array([o.entry_id for o in ovs]),
        np.array([o.ref_begin for o in ovs]), stride + 200)
    lens = torch.tensor([len(r) for r in reads], dtype=torch.int32)
    t = torch.as_tensor
    got = sam_cuda.sam_diff(
        t(r_arr), t(q_arr), lens,
        torch.tensor([len(q) for q in quals], dtype=torch.int32),
        torch.arange(n, dtype=torch.int32),
        t(np.array([o.rc for o in ovs], np.uint8)),
        t(np.array([o.query_begin for o in ovs], np.int32)),
        t(np.array([o.query_end for o in ovs], np.int32)), t(buf),
        t(n_runs), t(dwin), t(dlen), *sam_cuda.quality_tables("cpu"),
        1024, 1024)
    assert (got["cigar_n"] <= 1024).all() and (got["md_n"] <= 1024).all()
    checked = 0
    for k, o in enumerate(ovs):
        try:
            want = jsam.get_cigar_and_md(o, reads[k].decode("latin-1"),
                                         quals[k].decode("latin-1"),
                                         ents[o.entry_id].decode("latin-1"))
        except (IndexError, ValueError):
            # a `^` of the reference as the MD's last component (the walk
            # reads past its list) or taking a deletion for its `^` (a
            # deletion of a digit and more read as a number): only where
            # the reference holds `^`
            assert case == "caret_in_reference"
            continue
        checked += 1
        cig = got["cigar_txt"][k, :got["cigar_n"][k]].numpy().tobytes() \
            .decode("latin-1")
        md = got["md_txt"][k, :got["md_n"][k]].numpy().tobytes() \
            .decode("latin-1")
        lp = float(got["lp"][k])
        assert (cig, md, int(got["nm"][k])) == \
            (want.cigar, want.md, want.nm), (case, k)
        assert lp == want.log_probability and \
            10.0 ** lp == 10.0 ** want.log_probability, (case, k)
    assert checked >= 40
    if case == "past_entry_end":
        assert any("\0" in jsam.get_cigar_and_md(
            o, reads[k].decode(), quals[k].decode(),
            ents[o.entry_id].decode()).md for k, o in enumerate(ovs))


# --- io/sam_columns against the copied writer ---------------------------

def _chunk(case: str):
    """A chunk's objects: its ReadBatch, GenbankIndex (with genes) and
    reads_and_pairs as the device path hands them to the SAM text."""
    paired = case != "single_end"
    c, rng = _columns(11, 48, indel_share=0.3, end_share=0.1)
    names = [f"read{k}" for k in range(48)]
    batch = ReadBatch(names, c["reads"], c["lengths"], c["quality"],
                      paired=paired)
    offs = c["offsets"]
    entries = []
    for e in range(len(offs) - 1):
        genes = [Gene(gene_name=f"g{e}_{i}", protein_id=f"P{e}.{i}",
                      product=f"protein {i}", cds_start=300 * i,
                      cds_stop=300 * i + 250) for i in range(4)]
        entries.append(GenbankEntry(
            bases=c["bases"][offs[e]:offs[e + 1]].tobytes().decode(),
            taxonomy_id=100 + e, locus_tag=f"E{e}", genes=genes))
    gindex = GenbankIndex(entries)
    cig = _plain_cigar(c)
    rb, qb, qe = sam_cases.phase_a_ends(
        rng, cig["ref_begin"].numpy(), cig["query_begin"].numpy(),
        cig["query_end"].numpy(), c["lengths"])
    ovs = [pairing.AlignedOverlap(
        k, int(c["entry_id"][k]), int(c["rel_pos"][k]), bool(c["rc"][k]),
        int(cig["score"][k]), int(rb[k]), int(rb[k]) + 140, int(qb[k]),
        int(qe[k])) for k in range(48)]
    half = 24 if paired else 48
    reads = []
    for k in range(half):
        r1 = ovs[k]
        r2 = ovs[k + 24] if paired else None
        pairs = []
        for j in range(int(rng.integers(0, 4))):
            a = r1 if (j != 2 or not paired) else None
            b = r2 if j != 1 else None
            if a is None and b is None:
                a = r1
            score = int(rng.integers(50, 60))     # ties: the stable sort
            ref = [o.ref_begin for o in (a, b) if o is not None]
            pairs.append(pairing.PairedOverlap(
                score, (a or b).entry_id, min(ref), max(ref) + 140, 0, a,
                b))
        if case == "shared_overlap" and pairs:
            # the same overlap object in two pairs of the read
            pairs.append(pairing.PairedOverlap(
                pairs[0].combined_score + 1, pairs[0].entry_id,
                pairs[0].ref_start, pairs[0].ref_end, 0, pairs[0].r1,
                pairs[0].r2))
        reads.append(pairing.ReadPairAlignments(
            k, k + 24 if paired else k, pairs))
    config = PipelineConfig(report_cigar=True, paired_data=paired)
    if case == "top1_xa":
        config.num_sam_alignments = 1
        config.sam_xa = True
    return batch, gindex, reads, config


@pytest.mark.parametrize("case", ["paired", "single_end", "top1_xa",
                                  "shared_overlap", "relaunch"])
def test_sam_columns_match_copied_writer(case, monkeypatch):
    """relaunch: texts capped at 5 bytes and reference windows 40 bases
    short of the read, so that most rows take the second sam_diff
    launch with wider caps and windows."""
    if case == "relaunch":
        monkeypatch.setattr(sam_cuda, "TEXT_CAP", 5)
        monkeypatch.setattr(sam_columns, "WINDOW_PAD", -40)
        launches = []
        real = sam_cuda.sam_diff
        monkeypatch.setattr(sam_cuda, "sam_diff", lambda *a, **k: (
            launches.append(len(a[4])), real(*a, **k))[1])
    batch, gindex, reads, config = _chunk(case)
    assert sum(len(r.pairs) for r in reads) >= 20
    mine = copy.deepcopy(reads)
    want = io.StringIO()
    run._fill_cigars(reads, batch, gindex, config)
    for read in reads:
        sam_io.write_sam_pairs(want, read, batch, gindex, config)
    got = io.StringIO()
    sam_columns.write_sam(got, mine, batch, gindex, config, "cpu")
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) >= 20
    assert "XG:Z:g" in got.getvalue()
    # both sorted each read's pairs in place, the same way
    assert [[p.combined_score for p in r.pairs] for r in mine] == \
        [[p.combined_score for p in r.pairs] for r in reads]
    if case == "relaunch":
        assert len(launches) == 2 and launches[1] > launches[0] // 2
