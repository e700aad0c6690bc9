"""Drop-in module-path shim: the reference exposes its orchestrator as
`ssr_eval.eval` (SSR_Eval_Helper, BasicTestee); `ssr_eval_tpu_torch.eval`
re-exports the same names."""

from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper
from ssr_eval_tpu_torch.harness.testee import BasicTestee, BatchedTestee

__all__ = ["SSR_Eval_Helper", "BasicTestee", "BatchedTestee"]
