"""The Jacobi stencils: plain versions (:mod:`.ref`), the whole-array
kernel wrappers (:mod:`.kernel`) and the public ops (:mod:`.ops`)."""
