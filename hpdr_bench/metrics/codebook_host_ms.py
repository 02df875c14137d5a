"""Milliseconds of host time a compress call spends building the Huffman
codebook: the self time of the program's span ``stage.codebook_build``, less
its child ``stage.codebook_build.fetch`` (the histogram's copy to the host)."""

from ..program_spans import self_ms_per_call


def read(trace):
    return self_ms_per_call(trace, "stage.codebook_build", "compress")
