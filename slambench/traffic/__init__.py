"""Traffic generators. A traffic file ``<name>.json`` here names one of
these modules under ``generator``; its other keys are the module's
parameters, apart from the harness's own (``enable_ba``,
``ceiling_frames_per_s``, ``warmup_frames``, ``warmup_max_frames``,
``check_frames``, ``trace_frames``). A module gives ``make`` (the poses
and frames) and may give ``prepare`` (the system made ready once, after
its frame 1)."""
