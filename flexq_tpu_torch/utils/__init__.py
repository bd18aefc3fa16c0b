from flexq_tpu_torch.utils.benchmark import bandwidth_gbs, bench_fn, tflops
