"""The port's models (the reference's ``repro/models``): the decoder LM
(:mod:`.lm`) with its attention (:mod:`.attention`) and MoE FFN
(:mod:`.moe`), the zamba2 hybrid (:mod:`.zamba2`) on the Mamba2 layer
(:mod:`.mamba2`), the xLSTM LM (:mod:`.xlstm_lm`) on the mLSTM and sLSTM
blocks (:mod:`.xlstm`), the whisper encoder-decoder (:mod:`.whisper`),
and the shared pieces (:mod:`.common`).  Parameters are
trees of nested dicts of tensors, as the reference's are of arrays, so
``convert.params_from_numpy`` carries a reference tree across leaf by
leaf."""
