"""Multi-GPU paths over `torch.distributed`: the sharded MSM
(`sharded_msm_v2`) and the four-step sharded NTT (`sharded_ntt`)."""
