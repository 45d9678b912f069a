"""Host runtime: the data pipeline's native warps and codecs
(:mod:`.native`), a PNG reader over zlib (:mod:`.png`), and the named
spans the profiler records at the port's layer boundaries (:mod:`.spans`)."""
