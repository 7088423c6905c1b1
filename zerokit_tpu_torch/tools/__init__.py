"""Tools of the port that run on the card: python -m zerokit_tpu_torch.tools.<name>.

  * tc_mont_prototype: K6, the Fq Montgomery product with the reduction on
    the tensor cores, checked against K1 and timed beside it;
  * microbench: the card's integer, float and tensor-core rates and the
    lane throughput of the field and curve kernels;
  * profile_batch: where the device time of a warm depth-20 batch goes;
  * witness_graphs: a seeded graph holding every witness op code, for checks.
"""
