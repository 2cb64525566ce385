"""Models of the port (counterpart of `repro.models`): the GANs of the
paper's experiments; the LM zoo arrives with ROADMAP §A slice 6."""
