"""Model zoo of the port: the decoder-only text path of the reference's
src/repro/models, as nn.Modules."""
