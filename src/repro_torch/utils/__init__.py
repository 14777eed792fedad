"""Step accounting for the dry run (``step_analysis``)."""
