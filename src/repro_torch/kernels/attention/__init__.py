"""Flash attention: plain version (:mod:`.ref`), the kernel wrapper
(:mod:`.kernel`) and the public op with its model bridges (:mod:`.ops`)."""
