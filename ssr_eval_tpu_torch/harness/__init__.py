from ssr_eval_tpu_torch.harness.testee import BasicTestee, BatchedTestee
from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper
from ssr_eval_tpu_torch.harness.smoke import test

__all__ = ["BasicTestee", "BatchedTestee", "SSR_Eval_Helper", "test"]
