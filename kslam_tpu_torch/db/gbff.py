"""GenBank flat-file parser in linear time.

The same grammar and output as `db/genbank.index_from_gbff` (the guarded
copy of the reference package's parser, GenbankTools.h:481-527), which
appends every ORIGIN line to `entry.bases` and so copies the growing
sequence once a line: quadratic in an entry's length.  Here the
sequence lines of an entry are collected in a list and joined once at
its `//`; every other section goes through the copy's
`_parse_section`.  Nothing reads `entry.bases` before `//`.
"""

from __future__ import annotations

from typing import List

from .genbank import Gene, GenbankEntry, GenbankIndex, _parse_section


def _end_section(section: str, entry: GenbankEntry, parts: List[str]) -> None:
    """`_parse_section`, except that a sequence line (a section whose tag
    starts with a digit) goes to `parts`, upper-cased and without spaces,
    instead of onto `entry.bases`."""
    stripped = section.lstrip(" ")
    if stripped[:1].isdigit():
        space = stripped.find(" ")
        if space >= 0:
            parts.append(stripped[space:].replace(" ", "").upper())
    else:
        _parse_section(section, entry)


def index_from_gbff(paths: List[str]) -> GenbankIndex:
    """Sections are lines whose content starts within the first 12
    columns plus their continuations (joined keeping one leading space);
    entries end at '//', where their genes are sorted by CDS start and
    deduplicated on equal starts preferring the longer protein ID.  An
    entry that a file ends without '//' is dropped."""
    index = GenbankIndex()
    for path in paths:
        with open(path) as fh:
            section = ""
            entry = GenbankEntry()
            parts: List[str] = []
            for line in fh:
                line = line.rstrip("\n")
                stripped = line.lstrip(" ")
                if not stripped:
                    continue
                start_pos = len(line) - len(stripped)
                if start_pos >= 12:
                    section += line[start_pos - 1:]
                    continue
                _end_section(section, entry, parts)
                section = line
                if line == "//":
                    entry.bases = "".join(parts)
                    entry.genes.sort(key=lambda g: (g.cds_start,
                                                    -len(g.protein_id)))
                    deduped: List[Gene] = []
                    for g in entry.genes:
                        if deduped and deduped[-1].cds_start == g.cds_start:
                            continue
                        deduped.append(g)
                    entry.genes = deduped
                    index.entries.append(entry)
                    entry = GenbankEntry()
                    parts = []
    return index
