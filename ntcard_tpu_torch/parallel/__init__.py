"""Scale-out: one private sketch per local card (data_parallel) and one
process per host over torch.distributed (multihost), the port of
ntcard_tpu/parallel."""
