from maskdit_tpu_torch.sampling.edm import ablation_sampler, edm_sampler, edm_sigma_steps

__all__ = ["ablation_sampler", "edm_sampler", "edm_sigma_steps"]
