"""The reference's examples on the port, each a module with ``main(argv)``:

    quickstart          FedAIS against FedAll through ``api.FedEngine``
    variance_analysis   the paper's Eq. 3-5 / Theorem 1 and Eq. 7, empirically
    serve_lm            LM prefill + decode on any registered architecture

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
