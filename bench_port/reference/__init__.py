"""The plain reference: the two-tower + DCN model, its multi-task loss,
Adagrad and two-stage serving in plain PyTorch (fp32 products with the
operands rounded where the configuration rounds them), with no kernel,
cache or batching of the program. It imports nothing of the program and
takes nothing the program made: weights and inputs come from
``bench_port.datagen`` and the seed, and it works out again whatever the
program derives from them (item embeddings, the catalog's normalisation,
the cross-batch cache)."""
