"""Single-device decentralized-training simulation (port of
``repro/sim``)."""
