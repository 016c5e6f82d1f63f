"""Model forms: what set-up and counting take from the model's form, one
module a form, found by the name a configuration gives under "form"
(`forms/<form>.py`; "gat" where it gives none). A form module has

  port_args(config) -> dict   the keyword arguments of the port's
                              GATConfig, as plain data
  leaf_shapes(config)         the weights' layout in the port's parameter
                              layout: [((group, layer, key), shape,
                              bound)] in the order of the one flat draw
                              (inputs.make_weights)
  attention_forward(n, e, nh, f, dropout),
  attention_backward(n, e, nh, f, dropout)
                              (operations, bytes) of one layer's attention;
                              bytes None where no metric reads them
  outside_ops(n, ld, first)   operations of the products outside the
                              attention of the layer `ld`
                              (inputs.LayerDims), forward and backward
                              (`first`: layer 0, whose input needs no
                              gradient)

counted by portbench/counts' conventions. A form imports nothing of the
port, of JAX or of the JAX package: the reference imports it for the
weights.
"""
