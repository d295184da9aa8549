"""Decentralized learning methods (port of ``repro/optim``)."""
