"""The FlowNet2 reference-flow stack (the port of
vid2vid_tpu/models/flownet2): the four flow nets, FlowNet2 and its
variants, the FlowEstimator wrapper, .flo IO, flow losses, the flow
datasets and the standalone flow-net CLI (inference only)."""
