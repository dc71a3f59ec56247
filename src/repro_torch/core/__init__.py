"""Core library: the single-device BWT/FM index.

    alphabet        token/alphabet conventions (sentinel = 0)
    keypack         fused sort keys + packed q-gram init
    suffix_array    prefix doubling (seed oracle + fast engine)
    bwt             BWT from SA + inverse (validation)
    fm_index        C array, sampled Occ, backward search, locate
    convert         carry an index across packages as numpy arrays
    pipeline        end-to-end build_index() / SequenceIndex
"""
