"""Models of the port (counterpart of `repro.models`): the GANs of the
paper's experiments (`gan`) and the dense decoder LM (`model`, `layers`)
that the serving engine runs; the mixers and experts of the rest of the
LM zoo arrive with ROADMAP §A slice 6."""
