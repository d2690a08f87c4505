"""The port's measurement and setup tools, one module each, run as
``python -m cl_object_detection_tpu_torch.tools.<name>`` (the JAX
package's ``tools/`` scripts of the same names):

* setup: ``make_toy_dataset``, ``coco_tool``;
* the train step: ``bench_train`` (images/s, ``--split`` into forward,
  loss, backward and optimizer, MFU), ``bench_bwd_breakdown`` (each
  stage forward and forward + backward), ``mem_report`` (a step's peak
  memory);
* predict: ``bench_split`` (forward, post-process, backbone, FPN),
  ``bench_sweep`` (batch sizes, depths), ``bench_backbone`` (the R50
  backbone stage by stage, without its frozen-BN passes, float32),
  ``bench_fwd_floor`` (each stage against the H100's roofline);
* kernels: ``bench_nms``, ``bench_int8_matmul``;
* host and serving: ``bench_loader`` (the data loader), ``bench_serve``
  (latency percentiles of ``cli.serve`` per concurrency level).

Each measuring tool runs on the card unless given ``--cpu`` (it raises
without CUDA otherwise) and prints JSON records that carry the card's
``nvidia-smi`` name and power limit, or ``"device": "cpu"``.
"""
