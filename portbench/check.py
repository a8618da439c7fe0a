"""The comparison that decides `correct`: what the window's run wrote,
held to the plain reference.

  taxid_mismatches      reads of the sampled chunk whose _PerRead lines
                        differ from the reference's taxid: a wrong taxid,
                        a line missing from an instance of the chunk, or
                        a line for a read the reference leaves unhit
  abundance_mismatches  lines of _abbreviated that differ from the
                        reference's aggregation of the run's _PerRead
                        (combineTaxonomies, MetagenomicResults.h:149-176,
                        and writeAbbreviatedResultsFile, :237-249)
  chunks_lost           chunks fed whose tails never completed
  sam_line_mismatches   (SAM cells) reads of a sample of the chunk whose
                        SAM lines' flags, positions, CIGAR, MD and NM
                        differ from the reference's (reference/sam.py),
                        and instances of the chunk whose text differs

Each is exact: its limit is 0.
"""

from __future__ import annotations

import collections

LIMITS = {"taxid_mismatches": 0, "abundance_mismatches": 0,
          "chunks_lost": 0, "sam_line_mismatches": 0}


def per_read(path: str):
    """[(name, taxid)] of a _PerRead file, in order."""
    out = []
    with open(path) as fh:
        for line in fh:
            name, taxid = line.rstrip("\n").split("\t")
            out.append((name, int(taxid)))
    return out


def taxid_mismatches(lines, names, expected: dict, instances: int) -> int:
    """names: the sampled chunk's read names (pair index i -> names[i]);
    expected: {pair index: taxid} of the reference; instances: how many
    times the chunk completed in the run."""
    index = {n: i for i, n in enumerate(names)}
    seen = collections.defaultdict(list)
    for name, taxid in lines:
        i = index.get(name)
        if i is not None:
            seen[i].append(taxid)
    bad = 0
    for i in range(len(names)):
        got = seen.get(i, [])
        want = expected.get(i)
        if want is None:
            bad += len(got) > 0
        else:
            bad += len(got) != instances or any(t != want for t in got)
    return bad


def abbreviated(lines, taxonomy: dict, num_pairs: int):
    """The _abbreviated lines that the reads of `lines` give."""
    count = collections.Counter(t for _, t in lines)
    taxids = sorted(count)
    groups = []
    for gi, t in enumerate(taxids):
        n = count[t]
        if t == 0:
            continue
        if gi == 0 and len(lines) > 1:
            n -= 1                 # the first-row loss (:159-170)
            if n == 0:
                continue
        groups.append((t, n))
    groups.sort(key=lambda g: (-g[1], g[0]))
    return [f"{taxonomy.get(t, (0, '', ''))[2]}\t{n * 100.0 / num_pairs:.6g}"
            for t, n in groups]


def lines_of(path: str):
    """The lines of a text file, without their newlines."""
    with open(path) as fh:
        got = fh.read().split("\n")
    if got and got[-1] == "":
        got.pop()
    return got


def abundance_mismatches(got, want) -> int:
    """Lines of `got` (the _abbreviated file's) that differ from `want`,
    and the difference of their counts."""
    bad = abs(len(got) - len(want))
    return bad + sum(a != b for a, b in zip(got, want))


def sam_mismatches(texts: dict, names, sample, detail: dict, r1, r2,
                   bases, offsets, sw, num_alignments: int) -> int:
    """Reads of `sample` (pair indices of the chunk) whose SAM lines
    (flag, position, CIGAR, MD, NM, in order) differ from the
    reference's, plus every instance of the chunk whose text differs
    from the first's.  texts: {instance: the chunk's SAM text}."""
    import numpy as np
    from .reference import sam as S
    if not texts:
        return len(sample)
    first = texts[min(texts)]
    bad = sum(t != first for t in texts.values())
    got = S.parse_sam(first, [names[i] for i in sample])
    cols, ov, al = detail["cols"], detail["ov"], detail["al"]
    group = cols.group.cpu().numpy()
    pr = np.stack([cols.r1_idx.cpu().numpy(), cols.r2_idx.cpu().numpy(),
                   (cols.combined_score & 0xFFFFFFFF).cpu().numpy()], 1)
    o = [x.cpu().numpy() for x in (ov.read_id, ov.entry_id, ov.rel_pos,
                                   ov.rc, al.score, al.ref_begin,
                                   al.ref_end, al.query_begin, al.query_end)]
    n = r1.shape[0]

    class Rows:
        def __getitem__(self, i):
            return tuple(int(c[i]) if k != 3 else bool(c[i])
                         for k, c in enumerate(o))

    class Reads:
        def __getitem__(self, r):
            return (r1[r] if r < n else r2[r - n]).tobytes()

    class Entries(dict):
        def __missing__(self, e):
            a = bases[int(offsets[e]):int(offsets[e + 1])]
            self[e] = (a, S.SW_LUT[a])
            return self[e]

    entries, params = Entries(), S.SWParams(*sw)
    order = np.argsort(group, kind="stable")
    starts = np.searchsorted(group[order], sample, side="left")
    ends = np.searchsorted(group[order], sample, side="right")
    for g, a, b in zip(sample, starts.tolist(), ends.tolist()):
        pairs = [tuple(int(x) for x in pr[k]) for k in order[a:b]]
        want = S.read_lines(pairs, Rows(), Reads(), entries, params,
                            num_alignments) if pairs else []
        bad += got.get(names[g], []) != want
    return bad
