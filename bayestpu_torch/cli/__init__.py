"""Command-line entry points of the port, the JAX package's CLIs with the
same flags, defaults and output keys, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path). Each is ``main(argv) -> dict`` (or a
list) and runs as ``python -m bayestpu_torch.cli.<name>``:

- ``train``    ≙ ``train_qkeras_mcme.py`` + SW ``main.py``
- ``predict``  ≙ ``hls4ml_pred.py`` (acc/ECE/aPE verify)
- ``analyze``  ≙ ``results_analyzer.py`` CLI
- ``build``    ≙ ``hls4ml_build.py`` (a CUDA graph and its cost report)
- ``sweep``, ``figures``, ``time_cost``, ``verify_accuracy`` ≙ autobayes
"""
