// K3 on bf16 activations, the extractor's grouped route (design in
// convnext_group.cuh).

#include "convnext_group.cuh"

VS_ENTRY_GROUP(vs_cnx_group_bf16, __nv_bfloat16)
