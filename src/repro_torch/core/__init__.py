"""The DQGAN algorithm: compressors, error feedback, the exchange plans and
the trainer (counterpart of `repro.core`)."""
