from flexq_tpu_torch.bindings.torch_adapter import FlexQCausalLM

__all__ = ["FlexQCausalLM"]
