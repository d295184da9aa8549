"""Model zoo (port of ``repro/models``): attention + dense-FFN decoders."""
