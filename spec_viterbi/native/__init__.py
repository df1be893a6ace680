"""Native (C++) runtime components.

The reference's runtime is entirely native (C++/CUDA, SURVEY.md §1). Here
the compute path is XLA/Pallas, so the native layer here covers what remains
host-side and hot: corpus parsing (25 MB of text HMMs/sequences) and the
operator-cache file format. Python fallbacks exist for every native entry
point; the library is optional at runtime and built with ``make -C
spec_viterbi/native``.
"""
