"""The port's benchmark: the AXPYDOT program stream through
`repro_torch.blas.compile`, end to end on one CUDA card.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`. Each configuration,
traffic mix and metric is a file of its own under this folder, found by
the name the manifest gives it (`manifest.py`)."""
