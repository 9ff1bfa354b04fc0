from zigma_tpu_torch.evals.lm_harness import (MambaEvalLM, loglikelihood_batch,
                                              loglikelihood_rolling)

__all__ = ["MambaEvalLM", "loglikelihood_batch", "loglikelihood_rolling"]
