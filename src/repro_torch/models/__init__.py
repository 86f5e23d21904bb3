"""The port's models (the reference's ``repro/models``): the dense decoder
LM (:mod:`.lm`), its attention (:mod:`.attention`) and the shared pieces
(:mod:`.common`).  Parameters are trees of nested dicts of tensors, as the
reference's are of arrays, so ``convert.params_from_numpy`` carries a
reference tree across leaf by leaf."""
