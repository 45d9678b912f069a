"""Host data subsystem: the dataset scanners (:mod:`.meta`), decoding
(:mod:`.decode`) and the prefetching pipeline (:mod:`.pipeline`)."""
