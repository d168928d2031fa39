"""The paper's models (``small``) and the LM serving path of the dense GQA
and Mamba2 SSD families (``common``, ``rotary``, ``params``, ``attention``,
``ssd``, ``blocks``, ``transformer``)."""
