"""Host↔device block batching (port of ``cluster_tools_tpu/parallel/``):
``dispatch.py``'s block batch and the fused chain's per-batch read cache.
The sharded half (meshes, collectives) is ROADMAP Queue A 11."""
