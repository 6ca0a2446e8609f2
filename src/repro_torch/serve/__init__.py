"""LM serving of the port: the KV caches (`kvcache`) and the prefill and
decode steps (`steps`) of the reference's src/repro/serve. The SPDC
gateway comes with ROADMAP A11."""
