"""SAM output: byte-parity mirror of SAM.h.

Covers: soft-clipped cigar + MD + NM reconstruction with the per-base
quality log-probability model (SAM.h:33-237), flag composition
(SAM.h:307-323), pair mirroring for half-mapped pairs (SAM.h:352-433),
MAPQ = ceil(-10 log10(max(1 - p/sum p, 1e-5))) (SAM.h:493-499), the
numSAMAlignments cap and primary-first ordering (SAM.h:448-490), the
always-'*' SEQ/QUAL columns (SAM.h:285-289), and the header (SAM.h:513-531).

Note: the reference computes an XA string but the line that would print it
is commented out (SAM.h:304); we mirror the *output* (no XA tag).  --sam-xa
therefore only truncates output to the primary pair (SAM.h:509-510).
"""

from __future__ import annotations

import math
from typing import List, Optional

from ..config import PipelineConfig
from ..db.genbank import GenbankIndex
from ..ops import encode
from ..pipeline.pairing import AlignedOverlap, PairedOverlap, \
    ReadPairAlignments

# quality -> log10 probability tables (SAM.h:33-48); index 0 aliases 1
_MATCH_TABLE = [math.log10(1.0 - 10.0 ** (max(i, 1) / -10.0))
                for i in range(100)]
_MISMATCH_TABLE = [max(i, 1) / -10.0 for i in range(100)]


class SequenceDifference:
    def __init__(self):
        self.cigar = ""
        self.md = ""
        self.nm = 0
        self.log_probability = 0.0


def get_cigar_and_md(overlap: AlignedOverlap, read_bases: str,
                     read_quality: str, ref_bases: str) -> SequenceDifference:
    """SAM.h:101-237."""
    diff = SequenceDifference()
    if overlap.cigar is None:
        return diff
    query = (encode.reverse_complement_str(read_bases) if overlap.rc
             else read_bases)
    quality = read_quality[::-1] if overlap.rc else read_quality
    md_components: List[str] = []
    ref_pos = overlap.ref_begin
    query_pos = 0
    if overlap.query_begin > 0:
        diff.cigar += f"{overlap.query_begin}S"
        query_pos += overlap.query_begin
    for length, op in overlap.cigar:
        diff.cigar += str(length)
        if op == "M":
            diff.cigar += "M"
            num_match = 0
            for _ in range(length):
                r = ref_bases[ref_pos] if ref_pos < len(ref_bases) else "\0"
                q = query[query_pos] if query_pos < len(query) else "\0"
                qual = ord(quality[query_pos]) - 33 \
                    if query_pos < len(quality) else 1
                qual = min(max(qual, 0), 99)
                if r == q:
                    num_match += 1
                    diff.log_probability += _MATCH_TABLE[qual]
                else:
                    diff.nm += 1
                    if num_match:
                        md_components.append(str(num_match))
                    md_components.append(r)
                    diff.log_probability += _MISMATCH_TABLE[qual]
                    num_match = 0
                ref_pos += 1
                query_pos += 1
            if num_match:
                md_components.append(str(num_match))
        elif op == "I":
            diff.cigar += "I"
            diff.nm += length
            query_pos += length
        elif op == "D":
            diff.cigar += "D"
            md_components.append("^")
            deleted = []
            for _ in range(length):
                deleted.append(ref_bases[ref_pos]
                               if ref_pos < len(ref_bases) else "\0")
                diff.nm += 1
                ref_pos += 1
            md_components.append("".join(deleted))
    end_clip = len(query) - overlap.query_end - 1
    if end_clip > 0:
        diff.cigar += f"{end_clip}S"
    # MD merge loop (SAM.h:192-217)
    ambiguous = False
    i = 0
    while i < len(md_components):
        comp = md_components[i]
        if comp == "^":
            diff.md += comp
            i += 1
            diff.md += md_components[i]
            ambiguous = True
            i += 1
        elif comp and comp[0].isdigit():
            total = 0
            while i < len(md_components) and md_components[i][0].isdigit():
                total += int(md_components[i])
                i += 1
            diff.md += str(total)
            ambiguous = False
        else:
            if ambiguous:
                diff.md += "0"
                ambiguous = False
            diff.md += comp
            i += 1
    return diff


class SAMEntry:
    """SAM.h:238-323."""

    def __init__(self):
        self.qname = ""
        self.rname = ""
        self.pos = 0
        self.mapq = 255
        self.cigar = "*"
        self.rnext = "="
        self.pnext = 0
        self.tlen = 0
        self.multiple_segments = False
        self.all_segments_aligned = False
        self.this_unmapped = False
        self.next_unmapped = False
        self.rev_comp = False
        self.next_rev_comp = False
        self.first = False
        self.secondary = True
        self.md = ""
        self.align_score = 0
        self.nm = 0
        self.xs = 0
        self.xo = 0
        self.xt = 0
        self.xg = ""
        self.xp = ""
        self.xr = ""
        self.prob = 0.0

    def flag(self, paired_data: bool) -> int:
        f = 0
        if self.multiple_segments:
            f |= 0x1
        if self.all_segments_aligned:
            f |= 0x2
        if self.this_unmapped:
            f |= 0x4
        if self.next_unmapped:
            f |= 0x8
        if self.rev_comp:
            f |= 0x10
        if self.next_rev_comp:
            f |= 0x20
        if paired_data:
            f |= 0x40 if self.first else 0x80
        if self.secondary:
            f |= 0x100
        return f

    def line(self, config: PipelineConfig) -> str:
        out = (f"{self.qname}\t{self.flag(config.paired_data)}\t{self.rname}"
               f"\t{self.pos}\t{self.mapq}\t"
               f"{self.cigar if config.report_cigar else '*'}\t{self.rnext}"
               f"\t{self.pnext}\t{self.tlen}\t*\t*")
        if self.this_unmapped:
            return out
        if config.report_cigar:
            out += f"\tMD:Z:{self.md}"
        out += (f"\tAS:i:{self.align_score}\tXS:i:{self.xs}\tNM:i:{self.nm}"
                f"\tX0:i:{self.xo}")
        if self.xt != 0:
            out += f"\tXT:i:{self.xt}"
        if self.xg:
            out += f"\tXG:Z:{self.xg}"
        if self.xp:
            out += f"\tXP:Z:{self.xp}"
        if self.xr:
            out += f'\tXR:Z:"{self.xr}"'
        return out

    def init_from_overlap(self, overlap: AlignedOverlap, read_bases: str,
                          read_quality: str, index: GenbankIndex) -> None:
        entry = index.entries[overlap.entry_id]
        diff = get_cigar_and_md(overlap, read_bases, read_quality,
                                entry.bases)
        self.cigar = diff.cigar
        self.md = diff.md
        self.nm = diff.nm
        self.prob = 10.0 ** diff.log_probability
        self.rname = entry.locus_tag
        self.pos = overlap.ref_begin + 1
        self.align_score = overlap.score


def sam_from_pair(pair: PairedOverlap, batch, index: GenbankIndex,
                  config: PipelineConfig):
    """getSAMFromPair (SAM.h:352-433)."""
    entry = index.entries[pair.entry_id]
    r1 = SAMEntry()
    r2 = SAMEntry()
    r1.first = True
    gene = entry.get_gene(pair.ref_start, pair.ref_end)
    if gene is not None:
        r1.xg = r2.xg = gene.gene_name
        r1.xp = r2.xp = gene.protein_id
        r1.xr = r2.xr = gene.product
    r1.xt = r2.xt = entry.taxonomy_id
    conventional = True
    both = pair.has_r1 and pair.has_r2
    if config.paired_data:
        r1.multiple_segments = r2.multiple_segments = True
    if both:
        r1.all_segments_aligned = r2.all_segments_aligned = True
        conventional = pair.r1.ref_begin < pair.r2.ref_begin
        if pair.r1.rc:
            r1.rev_comp = True
            r2.next_rev_comp = True
        if pair.r2.rc:
            r2.rev_comp = True
            r1.next_rev_comp = True
    elif pair.has_r1:
        r1.next_unmapped = True
        r2.this_unmapped = True
        if pair.r1.rc:
            r1.rev_comp = True
    elif pair.has_r2:
        r2.next_unmapped = True
        r1.this_unmapped = True
        if pair.r2.rc:
            r2.rev_comp = True
    if pair.has_r1:
        o = pair.r1
        r1.init_from_overlap(o, batch.base_string(o.read_id),
                             batch.quality_string(o.read_id), index)
    if pair.has_r2:
        o = pair.r2
        r2.init_from_overlap(o, batch.base_string(o.read_id),
                             batch.quality_string(o.read_id), index)
    r1.pnext = r2.pos
    r2.pnext = r1.pos
    if not pair.has_r1:
        r1.rname = r2.rname
        r1.pos = r2.pos
        r2.pnext = r2.pos
        r1.pnext = r2.pos
    if not pair.has_r2:
        r2.rname = r1.rname
        r2.pos = r1.pos
        r1.pnext = r1.pos
        r2.pnext = r1.pos
    if not config.paired_data:
        r1.rnext = "*"
        r1.pnext = 0
        r1.next_unmapped = False
    tlen = pair.ref_end - pair.ref_start + 1
    if not (pair.has_r1 or pair.has_r2):
        tlen = 0
    if not conventional:
        tlen = -tlen
    r1.tlen = tlen
    r2.tlen = -tlen
    # SAM.h:269 declares `uint16_t XS`, so the u32 pseudo-assembly chain
    # score (which exceeds 65535 on any dense multi-read chain) is
    # TRUNCATED to 16 bits at emission (SAM.h:430-431) -- a reference
    # quirk mirrored for byte parity
    r1.xs = r2.xs = pair.combined_score & 0xFFFF
    return r1, r2


def write_sam_pairs(out, read: ReadPairAlignments, batch,
                    index: GenbankIndex, config: PipelineConfig) -> None:
    """writeSAMOutputPairs (SAM.h:443-512)."""
    if not read.pairs:
        return
    read.pairs.sort(key=lambda p: -p.combined_score)
    sam_pairs = []
    r1_hits = r2_hits = 0
    for pair in read.pairs:
        if pair.has_r1:
            r1_hits += 1
        if pair.has_r2:
            r2_hits += 1
        sam_pairs.append(sam_from_pair(pair, batch, index, config))
        if len(sam_pairs) >= config.num_sam_alignments:
            break
    r1_name = batch.names[read.r1_pos]
    r2_name = batch.names[read.r2_pos] if config.paired_data else r1_name
    r1_sum = r2_sum = 0.0
    for r1, r2 in sam_pairs:
        r1.qname = r1_name
        r2.qname = r2_name
        r1_sum += r1.prob
        r2_sum += r2.prob
        r1.xo = r1_hits
        r2.xo = r2_hits
    sam_pairs[0][0].secondary = False
    sam_pairs[0][1].secondary = False
    for r1, r2 in sam_pairs:
        # sumProb == 0 (all per-alignment probabilities underflowed, or
        # the segment never mapped): the reference computes 1 - 0/0 = NaN,
        # the `temp <= 0.00001` clamp is false for NaN (SAM.h:494-499),
        # and ceil(-10*log10(NaN)) = NaN lands in a uint8_t mapq -- on
        # x86-64 g++ that converts via cvttsd2si to INT_MIN whose low
        # byte is 0, so the binary prints mapq 0.  Substituting t = 1.0
        # (mapq = ceil(0) = 0) reproduces that byte-for-byte without the
        # undefined-behavior detour.
        t1 = 1.0 - (r1.prob / r1_sum if r1_sum else 0.0)
        t1 = max(t1, 0.00001)
        t2 = 1.0 - (r2.prob / r2_sum if r2_sum else 0.0)
        t2 = max(t2, 0.00001)
        r1.mapq = math.ceil(-10.0 * math.log10(t1))
        r2.mapq = math.ceil(-10.0 * math.log10(t2))
        out.write(r1.line(config) + "\n")
        if config.paired_data:
            out.write(r2.line(config) + "\n")
        if config.sam_xa:
            break


def sam_header(index: GenbankIndex, command_line: str) -> str:
    """getHeader (SAM.h:513-531)."""
    parts = ["@HD\tVN:1.0\tSO:unsorted\n"]
    for entry in index.entries:
        line = f"@SQ\tSN:{entry.locus_tag}\tLN:{len(entry.bases)}"
        if entry.taxonomy_id:
            line += f"\tSP:{entry.taxonomy_id}"
        parts.append(line + "\n")
    parts.append(f'@PG\tID:SLAM\tPN:SLAM\tVN:1.0\tCL:"{command_line}"\n')
    return "".join(parts)
