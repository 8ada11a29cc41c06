"""Watermark detection under speculative sampling — the port of
``repro.core.detection`` (records, the Gumbel Ars detectors, the SynthID
Bayesian detectors with the ψ model and the Bayes-MLP selector, the
generation-to-record pipeline and multi-key sweeps)."""
