"""The port's scripts, each runnable as
``python -m hydra_pspec_torch.scripts.<name>``, on the synthetic problem of
``validation/synth.py`` unless a data path is given:

* ``simple_example``: ``gibbs_sample_with_fg`` on one baseline;
* ``make_scaling_data``: N baselines as a uvh5 file plus their aux arrays;
* ``calc_vis_cov_matrices``: per-baseline covariances and eigenmodes;
* ``scaling_test``: a sweep over process counts and over devices in one
  process through the CLI's ``run_jobs``, with ``launch_scaling_sweep.sh``
  beside it;
* ``plot_test_data_results``: the recovered delay spectrum against the
  truth.
"""
