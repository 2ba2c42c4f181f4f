from gwdepth_tpu_torch.convert.from_jax import jax_params_to_state_dict

__all__ = ["jax_params_to_state_dict"]
