"""The plain reference that decides `correct`.

Plain torch (on the card or the CPU) and numpy; it imports nothing of
kslam_tpu_torch, kslam_tpu or jax.  It is a frozen copy of the port's
plain versions of the classification path (the CPU branch of each
ops/ module, the host insert-size model and chain rescoring), with
three departures that keep it apart from what the program runs:

  * the join is the exact binary search of the sorted keys
    (torch.searchsorted), not the sector table and its kernel;
  * Smith-Waterman is the plain column scan over the flat window (the
    read's length of reference), not the fused kernel over chunked
    windows;
  * the per-read LCA is the taxonomy's root-path walk on the host
    (TaxonomyDatabase.h:185-223), not the device's binary lifting.

It works every column out again from the generated genomes, index and
reads (reference/chunk.py), and takes nothing the program made.
"""
