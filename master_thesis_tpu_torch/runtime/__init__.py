"""Host runtime of the data pipeline: the native warps and codecs
(:mod:`.native`) and a PNG reader over zlib (:mod:`.png`)."""
