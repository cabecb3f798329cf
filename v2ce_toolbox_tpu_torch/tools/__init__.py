"""Tools of the port: the probe harness (`perf_probe`), the stage-2 and
baseline scorers (`stage2_eval`, `baseline_metric`), the training previews
(`vis_tools`) and the overfit demonstration (`overfit_demo`)."""
