"""Distribution: the FSDP x TP sharding policy on DTensor and the
expert-parallel MoE."""
