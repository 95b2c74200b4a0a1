"""The workflow scripts on the port, one module each, run as
``python -m lstm_unet_tpu_torch.scripts.<name>``.

Counterparts of the reference's ``scripts/*.py`` of the same names, with
their flags, defaults, printed lines and JSON keys, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path) where they compute:

- ``select_best``     — rank saved steps on val, soup the best two, confirm
                        on eval, write the durable ``best/`` model dir;
- ``calibrate_recipe``— sweep the postprocess recipe on val, confirm on eval;
- ``postprocess_sweep``— the postprocess over a grid, on saved probabilities;
- ``oracle_ceiling``  — the postprocess on GT-derived probabilities;
- ``carry_drift``     — bf16 against f32 LSTM carry over a long stream;
- ``heldout_protocol``— the held-out synthetic train / eval data;
- ``split_sweep``, ``seg_error_decomposition``, ``mask_agreement`` — scorers
                        of saved masks, on the host.
"""
