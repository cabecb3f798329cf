"""Tools of the port: the probe harness (`perf_probe`), the stage-2 and
baseline scorers (`stage2_eval`, `baseline_metric`), the training previews
(`vis_tools`), the overfit demonstration (`overfit_demo`), and the packet
tools `gen_phy_att` (rewrite the physical attention) and
`time_voxel_stat_calc` (voxel-value statistics)."""
